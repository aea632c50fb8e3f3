// Decode attention over an int8 K/V cache, for Hopper (sm_90a): the kernel
// bodies shared by decode_attention.cu (a dense cache) and paged_attention.cu
// (a page pool read through a page table).
//
// What every body computes, for one KV group g (the oracles
// decode_attend_q8kv_xla / decode_attend_q8kv_cur_xla of
// micronet_tpu/ops/decode_attention.py):
//
//   logit[r, s] = (sum_d bf16(q[r, d]) * kc[s, d]) * ks[s] / sqrt(D)   s < bound
//   m[r]        = max_s logit[r, s]
//   p[r, s]     = exp(logit[r, s] - m[r])                  (0 where s >= bound)
//   out[r, :]   = (sum_s bf16(p[r, s] * vs[s]) * vc[s, :]) / max(sum_s p[r, s], 1e-30)
//
// With CUR the current token's int8 K/V row (kcur, kscur, vcur, vscur) is one
// more always-visible column, taken as position `bound` of the same loops and
// rounded exactly like a cached one: at bound b it computes bit for bit what
// the body without CUR computes at bound b + 1 over a cache whose row b holds
// that row (the serving loop's deferred append equals append-then-attend).
//
// GQA: the R <= 8 query rows of a group are the query heads sharing it.
//
// Rounding points follow the oracles: the softmax takes the GLOBAL max before
// any exp, and p * v_scale is rounded to bf16 before the product with the
// codes. An online softmax would round p against a running max, which the
// oracles do not.
//
// What bounds it: bytes. A group reads n * (2 * D + 8) bytes of codes and
// scales (n visible positions) and does about 4 * R * D operations a
// position, far below the card's operations-per-byte ratio. At the serving
// shapes (64 groups, n up to 2,049 or 8,193) that is 18 to 67 MB: 6 to 20 us
// at 3.35 TB/s, so the kernel has to keep tens of KB in flight on every SM,
// spread each group over many SMs, and keep its arithmetic and its
// synchronisation off the bytes' critical path. Two regimes, chosen by the
// wrapper from S alone:
//
// - the cluster regime (S <= kClusterMaxS = 16,384): one thread-block cluster
//   of C = kCluster = 8 blocks per group (ops/decode_attention.py::_CLUSTER).
//   Block `rank` takes the contiguous slice [rank * L,
//   rank * L + L) of the group's n visible positions, L = n / C rounded up to
//   a multiple of 16 (ops/decode_attention.py::slice_len), so a slice depends
//   on n and S only, never on the number of groups. Each block
//   * loads q first, stages its slice's K and V scales (and, paged, the
//     slot's page-table row) in shared memory once;
//   * streams its K codes, then its V codes, in tiles of 64 positions through
//     a ring of kStages tiles with 16-byte cp.async (24 KB in flight a block,
//     five blocks an SM at S = 2,048; the V tiles are in flight while the
//     softmax runs);
//   * runs both products on bf16 mma.sync m16n8k16, the R query rows as the
//     8-column operand: QK^T with a 16-position tile per warp against q, and
//     PV with the codes transposed by the fragment layout against
//     bf16(p * v_scale). Every int8 code is a bf16 value and bf16(q),
//     bf16(p * vs) are bf16 values, so every product is exact; only the order
//     of the f32 sums differs from the twins;
//   * keeps its slice's logits in shared memory, writes its max into every
//     block's shared memory (distributed shared memory, then a cluster-scope
//     mbarrier arrive), forms p, its sum and bf16(p * vs) locally once all C
//     maxima are in, and sums its warps' PV partials in warp order;
//   * writes the k-th of C slabs of its R x D partial sums, and its
//     denominators, into block k; block k adds the C partials of its slab in
//     rank order, divides, and writes them. No atomics, no global scratch,
//     one launch; every exchange writes into the receiver, which waits for
//     all C writers, so no block waits for another to leave.
//   Past S = kOrderFromS the clusters take the groups heaviest first (cluster k the
//   group of k-th most positions), so that a launch of more clusters than the
//   card holds at once does not end with one heavy group running alone.
// - the split regime (S > kClusterMaxS, where a slice's logits would outgrow
//   shared memory): the positions are cut into splits of kSplit (the last
//   split also holds position S, where a current row may sit), one block per
//   (group, split). Pass 1 writes each split's logits to a global scratch and
//   its max; pass 2 takes the group's max over all splits, forms p and
//   bf16(p * v_scale) for its split and writes partial sums; a last kernel adds
//   the partials in split order. A split wholly past the bound writes zeros and
//   computes no exp. The split count depends on S only.
//
// Row addressing is a template parameter (DenseRows, PagedRows), so a paged
// pool and the dense view gathered from it run the same instructions in the
// same order: bit for bit equal results. The current row lands in the block,
// tile and lane that cache row `bound` would, and every sum runs in an order
// fixed by S, n and the thread layout, never by the number of groups, so a
// result does not depend on the batch and two calls give the same bits. No
// block reads a position at or past n: a tile's ragged tail keeps finite
// stale codes (any int8 byte is a finite bf16) that meet p = 0 or are masked
// out, and no scale past n is loaded.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

// Two diagnostic builds, for tools/attn_variants.py: MN_ATTN_NO_MATH drops
// the code conversions and MMAs (the copies, the softmax and the exchanges
// stay; the outputs are then wrong), MN_ATTN_TIMELINE stamps each block's
// progress (mn_attn_timeline in decode_attention.cu reads the stamps back).
#ifdef MN_ATTN_TIMELINE
constexpr int kStampBlocks = 4096, kStamps = 12;
__device__ unsigned long long mn_attn_stamps[kStampBlocks * kStamps];
#define MN_STAMP(k)                                                                   \
  do {                                                                                \
    if (threadIdx.x == 0 && blockIdx.x < kStampBlocks) {                              \
      unsigned long long v;                                                           \
      if ((k) == 0 || (k) == kStamps - 1)                                             \
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));                         \
      else                                                                            \
        v = clock64();                                                                \
      mn_attn_stamps[blockIdx.x * kStamps + (k)] = v;                                 \
    }                                                                                 \
  } while (0)
#else
#define MN_STAMP(k) \
  do {              \
  } while (0)
#endif

namespace mn_attn {
namespace {  // internal to each library that includes this header

namespace cg = cooperative_groups;

constexpr int kMaxD = 128;
constexpr int kMaxR = 8;
constexpr int kSmemOptin = 232448;  // bytes of shared memory one block may use (Hopper)

// the split regime
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;   // positions in flight per warp
constexpr int kSplit = 512;  // positions per split (ops/decode_attention.py::_SPLIT)

// the cluster regime
constexpr int kCWarps = 4;
constexpr int kCThreads = kCWarps * 32;
constexpr int kTile = 16 * kCWarps;  // positions a ring stage: one 16-position MMA tile a warp
constexpr int kStages = 4;           // ring tiles a block (3 measured the same, 6 and 8 slower)
constexpr int kMinBlocks = 5;        // blocks an SM the register budget is set for
constexpr int kRowBytes = kMaxD;     // a code row in shared memory
constexpr int kStageBytes = kTile * kRowBytes;
constexpr int kCluster = 8;          // blocks in a group's cluster: the portable maximum
constexpr int kClusterMaxS = 16384;  // ops/decode_attention.py::_MAX_CLUSTER_S
constexpr int kMaxOrderG = 256;      // the most groups the cluster regime orders by size
constexpr int kOrderFromS = 4096;    // caches longer than this: the heaviest groups first
constexpr int kStaticSmem = 3072;    // bound on the cluster kernel's static shared arrays
static_assert(kStages >= 2 && kStages * kStageBytes >= kCWarps * kMaxR * kMaxD * 4,
              "the PV partials reuse the drained ring");

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void unpack4(int w, float (&c)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = (float)(int8_t)((w >> (8 * i)) & 0xFF);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Cache position s of group g is row `row(g, s)`: its codes start at row * D,
// its scale is element `row` of the scales.
struct DenseRows {
  const int* bound;  // (G,) positions < bound are visible
  int S;
  __device__ __forceinline__ int visible(int g) const { return bound[g]; }
  __device__ __forceinline__ size_t row(int g, int s) const { return (size_t)g * S + s; }
  // the cluster regime: nothing to stage; slice_row(sub(g), s, tab, p0) = row(g, s)
  __device__ __forceinline__ int sub(int g) const { return g; }
  __device__ __forceinline__ bool prefetch_table(int, int*, int) const { return true; }
  __device__ __forceinline__ int stage_table(int, int, int, int*) const { return 0; }
  __device__ __forceinline__ size_t slice_row(int gs, int s, const int*, int) const {
    return (size_t)gs * S + s;
  }
};

// Pool codes (P, H, page, D), scales (P, H, 1, page); group g = slot * H + h.
struct PagedRows {
  const int* table;    // (slots, MP) pool page of each logical page
  const int* lengths;  // (slots,) positions < lengths are visible
  int H, page, MP;
  int shift;           // log2(page) for a power of two, else -1
  __device__ __forceinline__ int visible(int g) const { return lengths[g / H]; }
  __device__ __forceinline__ size_t row(int g, int s) const {
    const int slot = g / H;
    const int lp = s / page;
    const int pg = __ldg(table + (size_t)slot * MP + lp);
    return ((size_t)pg * H + (g - slot * H)) * page + (s - lp * page);
  }
  __device__ __forceinline__ int page_of(int s) const { return shift >= 0 ? s >> shift : s / page; }
  // The cluster regime. When the slot's whole table row fits in tab (cap
  // entries), it is copied there at once, before the slot's length is known
  // (cp.async, which the caller waits for); returns whether it did.
  __device__ __forceinline__ bool prefetch_table(int g, int* tab, int cap) const {
    if (MP > cap) return false;
    const int* trow = table + (size_t)(g / H) * MP;
    for (int k = threadIdx.x; k < MP; k += blockDim.x) cp_async4(tab + k, trow + k);
    return true;
  }
  // Otherwise the table entries of the pages holding cached positions [lo, hi)
  // into tab[0..] (at most hi - lo + 1 of them); returns the first one's
  // logical page. The caller synchronises before reading tab.
  __device__ __forceinline__ int stage_table(int g, int lo, int hi, int* tab) const {
    if (lo >= hi) return 0;
    const int p0 = page_of(lo), p1 = page_of(hi - 1);
    const int* trow = table + (size_t)(g / H) * MP;
    for (int k = threadIdx.x; k <= p1 - p0; k += blockDim.x) tab[k] = __ldg(trow + p0 + k);
    return p0;
  }
  // the head h = sub(g) of group g; the row of position s, from the staged table
  __device__ __forceinline__ int sub(int g) const { return g % H; }
  __device__ __forceinline__ size_t slice_row(int h, int s, const int* tab, int p0) const {
    if (shift >= 0)
      return (((size_t)tab[(s >> shift) - p0] * H + h) << shift) | (size_t)(s & (page - 1));
    const int lp = s / page;
    return ((size_t)tab[lp - p0] * H + h) * page + (s - lp * page);
  }
};

struct Operands {
  const int8_t* kc;
  const float* ks;
  const int8_t* vc;
  const float* vs;
  const float* q;  // (G, R, D)
  const int8_t* kcur;  // (G, D), with CUR only
  const float* kscur;  // (G,)
  const int8_t* vcur;
  const float* vscur;
  float* out;  // (G, R, D)
  int S, D;
};

// The kernels take the operands as __restrict__ parameters and rebuild an
// Operands inside: pointers read out of a struct parameter carry no promise
// that they do not alias, and without one the compiler keeps every load of a
// scale or a code behind the stores to shared memory before it.
#define MN_OPERAND_PARAMS                                                               \
  const int8_t *__restrict__ kc, const float *__restrict__ ks,                          \
      const int8_t *__restrict__ vc, const float *__restrict__ vs,                      \
      const float *__restrict__ q, const int8_t *__restrict__ kcur,                     \
      const float *__restrict__ kscur, const int8_t *__restrict__ vcur,                 \
      const float *__restrict__ vscur, float *__restrict__ out, int S, int D
#define MN_OPERANDS_IN_KERNEL \
  const Operands op { kc, ks, vc, vs, q, kcur, kscur, vcur, vscur, out, S, D }
#define MN_OPERAND_ARGS(o) \
  o.kc, o.ks, o.vc, o.vs, o.q, o.kcur, o.kscur, o.vcur, o.vscur, o.out, o.S, o.D

template <class Rows>
__device__ __forceinline__ int cached_bound(const Rows& rows, const Operands& op, int g) {
  const int nb = rows.visible(g);
  return nb < 0 ? 0 : (nb > op.S ? op.S : nb);
}

// ---------------------------------------------------------------- the cluster regime

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The four int8 codes of w as two bf16x2, exactly: bytes 0, 1 into lo and
// bytes 2, 3 into hi (the lower byte in the lower half). Each biased byte
// u = c + 128 becomes the f32 2^23 + u, minus 2^23 + 128 gives c, and c (at
// most 8 significant bits) is the top half of its f32.
__device__ __forceinline__ void codes_bf16x2(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A tile row holds one position's codes as eight 16-byte chunks; chunk c of
// row j sits at physical chunk c ^ swz(j), so the QK reads (rows g and g + 8,
// chunks t and t + 4 of an MMA group) and the PV reads (rows 2t, 2t + 1,
// 2t + 8, 2t + 9, chunk g) of a quarter-warp hit eight different chunks.
__device__ __forceinline__ int swz(int j) { return ((j & 1) << 2) ^ (((j >> 1) & 3) << 1); }

__device__ __forceinline__ void lds_chunk(const unsigned char* tile, int j, int c,
                                          uint32_t* w) {
  const uint4 v = *reinterpret_cast<const uint4*>(tile + j * kRowBytes + ((c ^ swz(j)) << 4));
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

// Bytes of shared memory the cluster kernel takes at R rows and slices of at
// most lmax positions (the layout at the head of attend_cluster_kernel).
inline size_t cluster_smem_bytes(int R, int lmax) {
  return (size_t)kStages * kStageBytes
       + 4 * ((size_t)R * lmax + 2 * (size_t)lmax)  // logits (then bf16(p * v_scale)), scales
       + 4 * ((size_t)R * kMaxD + kCluster)      // partial sums received
       + 4 * ((size_t)lmax + 2);                    // page-table slice
}

// Cluster-scope signalling through mbarriers in shared memory: a block writes
// into another block's shared memory, then arrives (release, cluster scope) on
// that block's barrier; the owner waits (acquire, cluster scope) for every
// arrival before it reads what was written.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(bar)),
               "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" :: "r"(remote)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {  // phase 0: each barrier serves once
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)) : "memory");
}

// One cluster of C blocks per group g = blockIdx.x / C; block `rank` of it
// takes positions [rank * L, rank * L + L) of the group's n, L = ceil(n / C)
// rounded up to 16 (<= lmax, which the wrapper sizes from S). Each block
// sends its maxima to every block of the cluster and, at the end, its partial
// sums to the block that owns each output (block k owns the k-th of C slabs of
// the R * D outputs); every exchange writes into the receiver's shared memory,
// so a block leaves as soon as its own outputs are written.
template <bool CUR, class Rows>
__global__ void __launch_bounds__(kCThreads, kMinBlocks)
attend_cluster_kernel(Rows rows, MN_OPERAND_PARAMS, int R, int C, int lmax, int vec16,
                      int order) {
  MN_OPERANDS_IN_KERNEL;
  MN_STAMP(0);
  MN_STAMP(1);
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;                                         // [kStages][kTile][128]
  float* lg = reinterpret_cast<float*>(smem + kStages * kStageBytes);  // [R][lmax] logits
  float* kss = lg + (size_t)R * lmax;                                  // [lmax] k scales
  float* vss = kss + lmax;                                             // [lmax] v scales
  float* recv = vss + lmax;                   // [C][slab] partial sums received
  int* tab = reinterpret_cast<int*>(recv + R * kMaxD + kCluster);  // [lmax + 2]
  // bf16(p * v_scale) of row r overwrites the first half of logit row r
  __nv_bfloat16* pv = reinterpret_cast<__nv_bfloat16*>(lg);  // row pitch 2 * lmax
  float* red = reinterpret_cast<float*>(ring);  // [kCWarps][R][kMaxD], once the ring drains
  __shared__ float wred[kCWarps][kMaxR];
  __shared__ float xmax[kCluster][kMaxR], xden[kCluster][kMaxR];
  __shared__ __align__(8) uint64_t bar_max, bar_sum;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;  // MMA row group and thread in group
  const int rank = (int)cluster.block_rank();
  int g = blockIdx.x / C;
  if (order) {
    // Cluster k takes the group of k-th most visible positions (ties in group
    // order): the heaviest groups start first, so a launch of more clusters
    // than the card holds at once does not leave one to run alone at the end.
    // Every block ranks the same counts the same way; a group's result does
    // not depend on which cluster computes it.
    __shared__ int counts[kMaxOrderG], pick;
    const int G = gridDim.x / C;
    for (int i = threadIdx.x; i < G; i += kCThreads) counts[i] = cached_bound(rows, op, i);
    __syncthreads();
    for (int i = threadIdx.x; i < G; i += kCThreads) {
      const int ni = counts[i];
      int before = 0;
      for (int j = 0; j < G; ++j) before += counts[j] > ni || (counts[j] == ni && j < i);
      if (before == g) pick = i;
    }
    __syncthreads();
    g = pick;
  }

  // q as the MMA's B operand, loaded first: k-tile kt = 4c + w takes
  // d = 64c + 16t + 4w + {0, 1} (k 2t, 2t + 1) and + {2, 3} (k 2t + 8, 2t + 9), the
  // bytes of code word w of chunk 4c + t; rows past R and d past D are 0.
  float4 qv[8];
  {
    const float* qrow = op.q + ((size_t)g * R + (gq < R ? gq : 0)) * op.D;
    const bool q16 = ((uintptr_t)qrow & 15) == 0;
#pragma unroll
    for (int kt = 0; kt < 8; ++kt) {
      const int d0 = 64 * (kt >> 2) + 16 * t + 4 * (kt & 3);
      qv[kt] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gq < R && d0 < op.D) {  // D % 4 == 0: all four or none
        if (q16) {
          qv[kt] = __ldg(reinterpret_cast<const float4*>(qrow + d0));
        } else {
          qv[kt].x = __ldg(qrow + d0);
          qv[kt].y = __ldg(qrow + d0 + 1);
          qv[kt].z = __ldg(qrow + d0 + 2);
          qv[kt].w = __ldg(qrow + d0 + 3);
        }
      }
    }
  }
  const bool whole_table = rows.prefetch_table(g, tab, lmax + 2);
  if (threadIdx.x == 0) {
    mbar_init(&bar_max, C);
    mbar_init(&bar_sum, C);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every block's barriers exist before any block signals them (the wait
  // comes after the QK pass)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const int nb = cached_bound(rows, op, g);
  const int n = nb + (CUR ? 1 : 0);  // visible positions; `nb` is the current row
  const int L = ((n + C - 1) / C + 15) & ~15;
  const int lo = min(rank * L, n), hi = min(lo + L, n);
  const int len = hi - lo;
  const int ntiles = (len + kTile - 1) / kTile;

  // the page table (paged: the slot's row, or else the slice's part), then the
  // slice's scales with the first tiles
  const int p0 = whole_table ? 0 : rows.stage_table(g, lo, min(hi, nb), tab);
  const int gs = rows.sub(g);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  for (int j = threadIdx.x; j < len; j += kCThreads) {
    const int s = lo + j;
    if (CUR && s == nb) {
      cp_async4(kss + j, op.kscur + g);
      cp_async4(vss + j, op.vscur + g);
    } else {
      const size_t rw = rows.slice_row(gs, s, tab, p0);
      cp_async4(kss + j, op.ks + rw);
      cp_async4(vss + j, op.vs + rw);
    }
  }
  // Tile i of the block: K tiles 0..ntiles-1, then V tiles; one commit group each.
  // Thread x copies chunk x % 8 of tile rows x / 8 + 16k, whose swizzle is the
  // same for every k.
  const int cchunk = threadIdx.x & 7, crow = threadIdx.x >> 3;
  const int coff = crow * kRowBytes + ((cchunk ^ swz(crow)) << 4);
  const bool con = cchunk * 16 < op.D;
  auto issue = [&](int i) {
    if (i < 2 * ntiles) {
      const bool v = i >= ntiles;
      const int base = lo + (v ? i - ntiles : i) * kTile;
      const int8_t* codes = (v ? op.vc : op.kc) + cchunk * 16;
      const int8_t* cur = CUR ? (v ? op.vcur : op.kcur) + (size_t)g * op.D + cchunk * 16 : nullptr;
      unsigned char* dst = ring + (i % kStages) * kStageBytes + coff;
      for (int j = crow; j < kTile && base + j < hi; j += kCThreads / 8) {
        const int s = base + j;
        const int8_t* src =
            (CUR && s == nb) ? cur : codes + rows.slice_row(gs, s, tab, p0) * op.D;
        unsigned char* d16 = dst + (j - crow) * kRowBytes;
        if (vec16) {
          if (con) cp_async16(d16, src);
        } else {
#pragma unroll
          for (int w = 0; w < 4; ++w)
            if (cchunk * 16 + w * 4 < op.D) cp_async4(d16 + w * 4, src + w * 4);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  uint32_t qf[8][2];
#pragma unroll
  for (int kt = 0; kt < 8; ++kt) {
    qf[kt][0] = pack_bf16x2(qv[kt].x, qv[kt].y);
    qf[kt][1] = pack_bf16x2(qv[kt].z, qv[kt].w);
  }
  MN_STAMP(2);

  // QK^T: warp w takes positions [16w, 16w + 16) of each tile
  const float sqrt_d = sqrtf((float)op.D);
  const int r0 = 2 * t, r1 = r0 + 1;
  float mx0 = -INFINITY, mx1 = -INFINITY;  // rows r0, r1
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(i + kStages - 1);
    const int j0 = i * kTile + warp * 16;
    if (j0 < len) {
      const unsigned char* tile = ring + (i % kStages) * kStageBytes;
      uint32_t ka[8], kb[8];  // rows gq and gq + 8: chunks t and t + 4
      lds_chunk(tile, warp * 16 + gq, t, ka);
      lds_chunk(tile, warp * 16 + gq, t + 4, ka + 4);
      lds_chunk(tile, warp * 16 + gq + 8, t, kb);
      lds_chunk(tile, warp * 16 + gq + 8, t + 4, kb + 4);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#ifndef MN_ATTN_NO_MATH
#pragma unroll
      for (int kt = 0; kt < 8; ++kt) {
        uint32_t alo, ahi, blo, bhi;
        codes_bf16x2(ka[kt], alo, ahi);
        codes_bf16x2(kb[kt], blo, bhi);
        mma_bf16(acc, alo, blo, ahi, bhi, qf[kt][0], qf[kt][1]);
      }
#else
      acc[0] = __uint_as_float(ka[0] & 0xFFFF) + __uint_as_float(kb[7] & 0xFFFF);
#endif
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // positions j0 + gq and j0 + gq + 8
        const int j = j0 + gq + 8 * h;
        if (j < len) {
          const float sc = kss[j];
          if (r0 < R) {
            const float l = __fdiv_rn(acc[2 * h] * sc, sqrt_d);
            lg[(size_t)r0 * lmax + j] = l;
            mx0 = fmaxf(mx0, l);
          }
          if (r1 < R) {
            const float l = __fdiv_rn(acc[2 * h + 1] * sc, sqrt_d);
            lg[(size_t)r1 * lmax + j] = l;
            mx1 = fmaxf(mx1, l);
          }
        }
      }
    }
  }
  MN_STAMP(3);

  // the group's max: the warps', then every block's (a max is exact in any order)
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  if (gq == 0) {
    if (r0 < R) wred[warp][r0] = mx0;
    if (r1 < R) wred[warp][r1] = mx1;
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (threadIdx.x < R * C) {  // thread (c, r) sends this block's max of row r to block c
    const int r = threadIdx.x % R, c = threadIdx.x / R;
    float m = wred[0][r];
#pragma unroll
    for (int w = 1; w < kCWarps; ++w) m = fmaxf(m, wred[w][r]);
    *cluster.map_shared_rank(&xmax[rank][r], c) = m;
  }
  __syncthreads();
  if (threadIdx.x < C) mbar_arrive_remote(&bar_max, threadIdx.x);
  mbar_wait(&bar_max);
  MN_STAMP(4);

  // p, its sum over the slice and bf16(p * v_scale), a warp per row (0 in the
  // last MMA tile's tail); p is written over its row's logits in order
  const int len16 = (len + 15) & ~15;
  for (int r = warp; r < R; r += kCWarps) {
    float m = xmax[0][r];
    for (int c = 1; c < C; ++c) m = fmaxf(m, xmax[c][r]);
    const float* lrow = lg + (size_t)r * lmax;
    __nv_bfloat16* prow = pv + (size_t)r * 2 * lmax;
    float sum = 0.f;
    for (int j0 = 0; j0 < len16; j0 += 128) {  // the same trip count in every lane
      float l[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + 32 * u + lane;
        l[u] = j < len ? lrow[j] : 0.f;
      }
      __syncwarp();  // every lane's logits read before any lane's p overwrites them
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + 32 * u + lane;
        float pvs = 0.f;
        if (j < len) {
          const float p = expf(l[u] - m);
          sum += p;
          pvs = p * vss[j];
        }
        if (j < len16) prow[j] = __float2bfloat16_rn(pvs);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) wred[0][r] = sum;  // this block's denominator of row r
  }
  MN_STAMP(5);

  // PV: out^T[d, r] += vc^T[d, s] * pv[s, r]. M-tile mt row gq is d = 16gq + 2mt,
  // row gq + 8 is d + 1; k 2t, 2t + 1, 2t + 8, 2t + 9 are positions j0 + the same.
  // A thread reads chunk gq (d = 16gq..16gq+15) of its four positions' rows.
  float acc[8][4];
#pragma unroll
  for (int mt = 0; mt < 8; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
  const int rr = gq < R ? gq : R - 1;  // B columns past R: a copy, never stored
  for (int i = ntiles; i < 2 * ntiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(i + kStages - 1);
    const int j0 = (i - ntiles) * kTile + warp * 16;
    if (j0 < len) {
      const unsigned char* tile = ring + (i % kStages) * kStageBytes;
      const int jr = warp * 16 + 2 * t;
      uint32_t x[4], y[4], z[4], u[4];
      lds_chunk(tile, jr, gq, x);
      lds_chunk(tile, jr + 1, gq, y);
      lds_chunk(tile, jr + 8, gq, z);
      lds_chunk(tile, jr + 9, gq, u);
      const __nv_bfloat16* prow = pv + (size_t)rr * 2 * lmax + j0 + 2 * t;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(prow);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(prow + 8);
#ifdef MN_ATTN_NO_MATH
      acc[0][0] += __uint_as_float((x[0] ^ y[1] ^ z[2] ^ u[3] ^ b0 ^ b1) & 0xFFFF);
#else
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        uint32_t a0, a1, a2, a3;
        codes_bf16x2(__byte_perm(x[w], y[w], 0x5140), a0, a1);  // bytes 0 and 1 of x, y
        codes_bf16x2(__byte_perm(z[w], u[w], 0x5140), a2, a3);
        mma_bf16(acc[2 * w], a0, a1, a2, a3, b0, b1);
        codes_bf16x2(__byte_perm(x[w], y[w], 0x7362), a0, a1);  // bytes 2 and 3
        codes_bf16x2(__byte_perm(z[w], u[w], 0x7362), a2, a3);
        mma_bf16(acc[2 * w + 1], a0, a1, a2, a3, b0, b1);
      }
#endif
    }
  }
  MN_STAMP(6);

  // the warps' partials, added in warp order; element e = r * D + d of the
  // block's sums goes to slot [rank][e % slab] of block e / slab
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + h;
    if (r < R) {
      float* dst = red + ((size_t)warp * R + r) * kMaxD + 16 * gq;
#pragma unroll
      for (int mt = 0; mt < 8; ++mt) {
        dst[2 * mt] = acc[mt][h];
        dst[2 * mt + 1] = acc[mt][2 + h];
      }
    }
  }
  __syncthreads();
  const int E = R * op.D, slab = (E + C - 1) / C;
  for (int e = threadIdx.x; e < E; e += kCThreads) {
    const int r = e / op.D, i = r * kMaxD + (e - r * op.D);
    float o = red[i];
#pragma unroll
    for (int w = 1; w < kCWarps; ++w) o += red[(size_t)w * R * kMaxD + i];
    const int k = e / slab;
    *cluster.map_shared_rank(recv + rank * slab + (e - k * slab), k) = o;
  }
  if (threadIdx.x < R * C) {  // thread (c, r) sends this block's denominator of row r to block c
    const int r = threadIdx.x % R, c = threadIdx.x / R;
    *cluster.map_shared_rank(&xden[rank][r], c) = wred[0][r];
  }
  MN_STAMP(7);
  __syncthreads();
  if (threadIdx.x < C) mbar_arrive_remote(&bar_sum, threadIdx.x);
  mbar_wait(&bar_sum);
  MN_STAMP(8);

  // this block's slab of the outputs: the C partials added in rank order
  for (int e = rank * slab + threadIdx.x; e < min(E, rank * slab + slab); e += kCThreads) {
    const int r = e / op.D;
    float o = 0.f, den = 0.f;
    for (int c = 0; c < C; ++c) {
      o += recv[c * slab + (e - rank * slab)];
      den += xden[c][r];
    }
    op.out[(size_t)g * E + e] = o / fmaxf(den, 1e-30f);
  }
  MN_STAMP(9);
  MN_STAMP(11);
}

// Runs `set` (a kernel's cudaFuncSetAttribute calls) once per device: each
// lambda type, one per kernel instantiation, keeps its own record.
template <class F>
cudaError_t once_per_device(F set) {
  static std::atomic<unsigned long long> done{0};  // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (bit & done.load(std::memory_order_acquire)) return cudaSuccess;
  err = set();
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// The cluster kernel may take all the dynamic shared memory a block can have
// beside its static arrays.
template <bool CUR, class Rows>
cudaError_t cluster_attributes() {
  return once_per_device([] {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, attend_cluster_kernel<CUR, Rows>);
    if (err != cudaSuccess) return err;
    int dev = 0, optin = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(attend_cluster_kernel<CUR, Rows>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                optin - (int)fa.sharedSizeBytes);
  });
}

template <bool CUR, class Rows>
cudaLaunchConfig_t cluster_config(int G, int R, int C, int lmax, cudaStream_t st,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)G * (unsigned)C);
  cfg.blockDim = dim3(kCThreads);
  cfg.dynamicSmemBytes = cluster_smem_bytes(R, lmax);
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool CUR, class Rows>
cudaError_t launch_cluster(const Rows& rows, const Operands& op, int G, int R, int C, int lmax,
                           bool vec16, cudaStream_t st) {
  cudaError_t err = cluster_attributes<CUR, Rows>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<CUR, Rows>(G, R, C, lmax, st, &attr);
  // long caches: the heaviest groups first (see the kernel); never past kMaxOrderG groups
  const int order = op.S > kOrderFromS && G <= kMaxOrderG;
  err = cudaLaunchKernelEx(&cfg, attend_cluster_kernel<CUR, Rows>, rows, MN_OPERAND_ARGS(op), R,
                           C, lmax, (int)vec16, order);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// How many clusters of the CUR kernel fit on the card at once (0 if none).
template <class Rows>
cudaError_t cluster_occupancy(int G, int R, int C, int lmax, int* clusters) {
  cudaError_t err = cluster_attributes<true, Rows>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<true, Rows>(G, R, C, lmax, 0, &attr);
  return cudaOccupancyMaxActiveClusters(clusters, attend_cluster_kernel<true, Rows>, &cfg);
}

// ---------------------------------------------------------------- the split regime

template <int R>
__device__ __forceinline__ void load_q(const Operands& op, int g, float (&qv)[R][4]) {
  const int lane = threadIdx.x & 31;
  const bool on = lane * 4 < op.D;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      qv[r][c] = on ? bf16_round(op.q[((size_t)g * R + r) * op.D + lane * 4 + c]) : 0.f;
}

// Logits of positions [lo, hi): a warp per position. Lane 0 writes logit
// (r, s) to dst[r * ld + s - lo] and keeps its running max in mx (a max is
// exact in any order).
template <int R, bool CUR, class Rows>
__device__ __forceinline__ void logits_pass(const Rows& rows, const Operands& op, int g, int nb,
                                            int lo, int hi, const float (&qv)[R][4], float* dst,
                                            int ld, float (&mx)[R]) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool lane_on = lane * 4 < op.D;
  const float sqrt_d = sqrtf((float)op.D);
  for (int s0 = lo + warp * kUnroll; s0 < hi; s0 += kWarps * kUnroll) {
    int w[kUnroll];
    float sc[kUnroll];  // each position's scale, loaded with its codes
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u;
      w[u] = 0;
      sc[u] = 0.f;
      if (s < hi) {
        const int8_t* row;
        if (CUR && s == nb) {
          row = op.kcur + (size_t)g * op.D;
          sc[u] = __ldg(op.kscur + g);
        } else {
          const size_t rw = rows.row(g, s);
          row = op.kc + rw * op.D;
          sc[u] = __ldg(op.ks + rw);
        }
        if (lane_on) w[u] = __ldg(reinterpret_cast<const int*>(row + lane * 4));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u;
      if (s >= hi) break;
      float k4[4];
      unpack4(w[u], k4);
      float part[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // bf16 x int8 products are exact in f32
        part[r] = ((qv[r][0] * k4[0] + qv[r][1] * k4[1]) + qv[r][2] * k4[2]) + qv[r][3] * k4[3];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part[r] += __shfl_xor_sync(0xffffffffu, part[r], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float l = __fdiv_rn(part[r] * sc[u], sqrt_d);
          dst[r * ld + s - lo] = l;
          mx[r] = fmaxf(mx[r], l);
        }
      }
    }
  }
}

// The block's max of each row's mx into m (every thread gets it).
template <int R>
__device__ __forceinline__ void block_max(float (&mx)[R], float (*wmax)[R], float (&m)[R]) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
    if ((threadIdx.x & 31) == 0) wmax[warp][r] = mx[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = wmax[0][r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m[r] = fmaxf(m[r], wmax[w][r]);
  }
}

// p = exp(logit - m) over [lo, hi), thread-strided: the logits are read from
// src[r * lds + s - lo], bf16(p * v_scale) is written to pv[r * ldp + s - lo],
// and each row's sum of p over the block lands in wsum[warp][r] (warp order).
template <int R, bool CUR, class Rows>
__device__ __forceinline__ void softmax_pass(const Rows& rows, const Operands& op, int g, int nb,
                                             int lo, int hi, const float* src, int lds,
                                             float* pv, int ldp, const float (&m)[R],
                                             float (*wsum)[R]) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float sum = 0.f;
    for (int s = lo + threadIdx.x; s < hi; s += kThreads) {
      const float p = expf(src[r * lds + s - lo] - m[r]);
      sum += p;
      const float vsc = (CUR && s == nb) ? __ldg(op.vscur + g) : __ldg(op.vs + rows.row(g, s));
      pv[r * ldp + s - lo] = bf16_round(p * vsc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if ((threadIdx.x & 31) == 0) wsum[warp][r] = sum;
  }
}

// sum_s pv[r, s] * vc[s, :] over [lo, hi), a warp per position: each warp's
// partial lands in red[(warp * R + r) * kMaxD + d] (red holds kWarps * R *
// kMaxD floats), added over the warps by warp_sum. Ends with the block
// synchronised.
template <int R, bool CUR, class Rows>
__device__ __forceinline__ void weighted_pass(const Rows& rows, const Operands& op, int g, int nb,
                                              int lo, int hi, const float* pv, int ldp,
                                              float* red) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool lane_on = lane * 4 < op.D;
  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int s0 = lo + warp * kUnroll; s0 < hi; s0 += kWarps * kUnroll) {
    int w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u;
      w[u] = 0;
      if (s < hi && lane_on) {
        const int8_t* row =
            (CUR && s == nb) ? op.vcur + (size_t)g * op.D : op.vc + rows.row(g, s) * op.D;
        w[u] = __ldg(reinterpret_cast<const int*>(row + lane * 4));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u;
      if (s >= hi) break;
      float v4[4];
      unpack4(w[u], v4);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = pv[r * ldp + s - lo];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(p, v4[c], acc[r][c]);  // exact product
      }
    }
  }
  if (lane_on) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) red[(warp * R + r) * kMaxD + lane * 4 + c] = acc[r][c];
  }
  __syncthreads();
}

// The warps' partials of (r, d) from weighted_pass, added in warp order.
template <int R>
__device__ __forceinline__ float warp_sum(const float* red, int r, int d) {
  float o = red[r * kMaxD + d];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) o += red[(w * R + r) * kMaxD + d];
  return o;
}

__device__ __forceinline__ void split_range(int S, int nsplit, int j, int n, int& lo, int& hi) {
  lo = j * kSplit;
  hi = (j == nsplit - 1) ? S + 1 : lo + kSplit;  // the last split holds position S
  hi = hi < n ? hi : n;
}

// Pass 1, block (g, j): logits of split j into lg[g][r][s] (ld S + 1) and
// the split's max of each row into smax[g][j][r] (-inf for an empty split).
template <int R, bool CUR, class Rows>
__global__ void __launch_bounds__(kThreads)
split_logits_kernel(Rows rows, MN_OPERAND_PARAMS, float* __restrict__ lg,
                    float* __restrict__ smax, int nsplit) {
  MN_OPERANDS_IN_KERNEL;
  __shared__ float wmax[kWarps][R];
  const int g = blockIdx.x, j = blockIdx.y;
  const int nb = cached_bound(rows, op, g);
  int lo, hi;
  split_range(op.S, nsplit, j, nb + (CUR ? 1 : 0), lo, hi);
  float mx[R], m[R];
#pragma unroll
  for (int r = 0; r < R; ++r) mx[r] = -INFINITY;
  if (lo < hi) {
    float qv[R][4];
    load_q<R>(op, g, qv);
    logits_pass<R, CUR>(rows, op, g, nb, lo, hi, qv,
                        lg + (size_t)g * R * (op.S + 1) + lo, op.S + 1, mx);
  }
  block_max<R>(mx, wmax, m);
  if (threadIdx.x < R) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (threadIdx.x == r) smax[((size_t)g * nsplit + j) * R + r] = m[r];
  }
}

// Pass 2, block (g, j): the group's max over every split, then p, its sum and
// the weighted sum of split j into pden[g][j][r] and pacc[g][j][r][d].
template <int R, bool CUR, class Rows>
__global__ void __launch_bounds__(kThreads)
split_values_kernel(Rows rows, MN_OPERAND_PARAMS, const float* __restrict__ lg,
                    const float* __restrict__ smax, float* __restrict__ pden,
                    float* __restrict__ pacc, int nsplit) {
  MN_OPERANDS_IN_KERNEL;
  extern __shared__ float smem_f[];
  float* red = smem_f;                        // [kWarps][R][kMaxD]
  float* pvb = smem_f + kWarps * R * kMaxD;   // [R][kSplit + 1] bf16(p * vs)
  __shared__ float wsum[kWarps][R];
  const int g = blockIdx.x, j = blockIdx.y;
  const int nb = cached_bound(rows, op, g);
  int lo, hi;
  split_range(op.S, nsplit, j, nb + (CUR ? 1 : 0), lo, hi);
  const size_t part = (size_t)g * nsplit + j;
  if (lo >= hi) {  // wholly past the bound: contributes nothing
    for (int i = threadIdx.x; i < R * op.D; i += kThreads) pacc[part * R * op.D + i] = 0.f;
    if (threadIdx.x < R) pden[part * R + threadIdx.x] = 0.f;
    return;
  }
  float m[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = smax[(size_t)g * nsplit * R + r];
    for (int jj = 1; jj < nsplit; ++jj) m[r] = fmaxf(m[r], smax[((size_t)g * nsplit + jj) * R + r]);
  }
  softmax_pass<R, CUR>(rows, op, g, nb, lo, hi, lg + (size_t)g * R * (op.S + 1) + lo, op.S + 1,
                       pvb, kSplit + 1, m, wsum);
  __syncthreads();
  weighted_pass<R, CUR>(rows, op, g, nb, lo, hi, pvb, kSplit + 1, red);
  for (int i = threadIdx.x; i < R * op.D; i += kThreads) {
    const int r = i / op.D, d = i - r * op.D;
    pacc[(part * R + r) * op.D + d] = warp_sum<R>(red, r, d);
  }
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    float den = 0.f;
    for (int w = 0; w < kWarps; ++w) den += wsum[w][r];
    pden[part * R + r] = den;
  }
}

// Pass 3, block g: the partials added in split order.
__global__ void __launch_bounds__(kThreads)
split_combine_kernel(const float* __restrict__ pden, const float* __restrict__ pacc,
                     float* __restrict__ out, int nsplit, int R, int D) {
  const int g = blockIdx.x;
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    float o = 0.f, den = 0.f;
    for (int j = 0; j < nsplit; ++j) {
      const size_t part = (size_t)g * nsplit + j;
      o += pacc[(part * R + r) * D + d];
      den += pden[part * R + r];
    }
    out[((size_t)g * R + r) * D + d] = o / fmaxf(den, 1e-30f);
  }
}

inline int split_count(int S) { return (S + kSplit - 1) / kSplit; }

// Floats of scratch the split regime needs (ops/decode_attention.py::split_scratch_floats).
inline long long split_scratch_floats(int G, int S, int D, int R) {
  return (long long)G * R * ((long long)S + 1 + (long long)split_count(S) * (D + 2));
}

template <int R, bool CUR, class Rows>
cudaError_t launch_split(const Rows& rows, const Operands& op, int G, float* scratch,
                         cudaStream_t st) {
  constexpr size_t kValuesSmem = sizeof(float) * ((size_t)kWarps * R * kMaxD + (size_t)R * (kSplit + 1));
  cudaError_t err = once_per_device([] {
    return cudaFuncSetAttribute(split_values_kernel<R, CUR, Rows>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kValuesSmem);
  });
  if (err != cudaSuccess) return err;
  const int nsplit = split_count(op.S);
  float* lg = scratch;                                  // [G][R][S + 1]
  float* smax = lg + (size_t)G * R * (op.S + 1);        // [G][nsplit][R]
  float* pden = smax + (size_t)G * nsplit * R;          // [G][nsplit][R]
  float* pacc = pden + (size_t)G * nsplit * R;          // [G][nsplit][R][D]
  const dim3 grid(G, nsplit);
  split_logits_kernel<R, CUR, Rows><<<grid, kThreads, 0, st>>>(rows, MN_OPERAND_ARGS(op), lg,
                                                                smax, nsplit);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  split_values_kernel<R, CUR, Rows><<<grid, kThreads, kValuesSmem, st>>>(
      rows, MN_OPERAND_ARGS(op), lg, smax, pden, pacc, nsplit);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  split_combine_kernel<<<G, kThreads, 0, st>>>(pden, pacc, op.out, nsplit, R, op.D);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- entry

// Whether every code row lies on 16 bytes (the cluster regime's 16-byte
// copies; 4-byte copies otherwise).
inline bool rows_16b(const Operands& op, bool cur) {
  auto a16 = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  return op.D % 16 == 0 && a16(op.kc) && a16(op.vc) && (!cur || (a16(op.kcur) && a16(op.vcur)));
}

// The cluster regime when cluster > 0 (clusters of kCluster blocks, slices of
// at most lmax positions), else the split regime over scratch.
template <class Rows>
cudaError_t dispatch(const Rows& rows, const Operands& op, int G, int R, bool cur, int cluster,
                     int lmax, float* scratch, cudaStream_t st) {
  if (cluster > 0) {
    const bool vec16 = rows_16b(op, cur);
    return cur ? launch_cluster<true>(rows, op, G, R, cluster, lmax, vec16, st)
               : launch_cluster<false>(rows, op, G, R, cluster, lmax, vec16, st);
  }
#define MN_CASE(RR)                                                       \
  case RR:                                                                \
    return cur ? launch_split<RR, true>(rows, op, G, scratch, st)         \
               : launch_split<RR, false>(rows, op, G, scratch, st);
  switch (R) {
    MN_CASE(1)
    MN_CASE(2)
    MN_CASE(3)
    MN_CASE(4)
    MN_CASE(5)
    MN_CASE(6)
    MN_CASE(7)
    MN_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef MN_CASE
}

// Checks shared by the entry points; true when the arguments are usable. The
// cluster regime (cluster > 0) takes S <= kClusterMaxS, clusters of kCluster
// blocks and slices of lmax positions (a multiple of 16) that
// cover S + 1 and fit in shared memory; the split regime a scratch of
// split_scratch_floats.
inline bool valid_args(int G, int S, int D, int R, int cluster, int lmax, const void* scratch,
                       long long scratch_floats) {
  if (G <= 0 || S <= 0 || D <= 0 || D > kMaxD || D % 4 || R < 1 || R > kMaxR) return false;
  if (cluster > 0)
    return S <= kClusterMaxS && cluster == kCluster && lmax > 0 && lmax % 16 == 0 &&
           (long long)lmax * cluster >= (long long)S + 1 &&
           (long long)G * cluster <= 0x7fffffffLL &&
           cluster_smem_bytes(R, lmax) + kStaticSmem <= (size_t)kSmemOptin;
  return scratch != nullptr && scratch_floats >= split_scratch_floats(G, S, D, R);
}

#undef MN_OPERAND_PARAMS
#undef MN_OPERANDS_IN_KERNEL
#undef MN_OPERAND_ARGS

}  // namespace
}  // namespace mn_attn
