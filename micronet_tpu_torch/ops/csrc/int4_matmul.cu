// W4A16 matmuls over packed int4 weights, for Hopper (sm_90a).
//
// K3 replaces the TPU kernel micronet_tpu/ops/int4_matmul.py::int4_matmul_grouped_hl8
// (Pallas body _kernel_grouped_hl8). It computes what the XLA oracle
// int4_matmul_grouped_hl8_xla computes:
//
//   out[m, n] = sum_g  scale[g, n] * sum_{k in group g} bf16(x[m, k]) * q[k, n]
//
// with f32 accumulation. Layout (the JAX package's, kept as is): packed row r of
// the (K/2, N) int8 array holds weight row r in its low nibble and row K/2 + r in
// its high nibble, stored as the hl8 byte b = 16*q_hi + (q_lo + 8). Packed group
// gi (rows gi*g .. gi*g+g-1) feeds scale row gi (low half) and g1 + gi (high half),
// g1 = (K/2)/g. The v5e three-dot identity and float-floor unpack are not carried
// over. The codes enter the tensor cores exact (bf16(x) * a 4-bit code is exact in
// f32); each group's partial dot, low half and high half apart, is multiplied by its
// column scale in f32 and added to the total (fma), so no weight is rounded by its
// scale. (K9's trick of pre-scaled bf16 weights would round each weight by up to 2^-8.)
//
// Dequantize, both regimes: with the byte of packed row r at bits 0-7 and the byte of
// another row at bits 16-23 of v, (v & 0x000F000F) | 0x43004300 is two bf16 128 + u_lo,
// u_lo = q_lo + 8 (the hl8 low nibble is already offset), and ((v >> 4) & 0x000F000F) ^
// 0x43084308 is two bf16 128 + (q_hi + 8) (the high nibble is two's complement); one
// bf16x2 fma subtracts 136 from both: the codes exactly. A zero byte is q_lo = -8, not 0,
// so no edge relies on zero weight bytes: K is padded with x = 0, N edges are masked.
//
// K3 runs in two regimes, chosen by the wrapper from M and the group alone
// (ops/int4_matmul.py::_k3_regime):
//
// Regime A, decode (M <= 128, or a group that is not a multiple of 16 rows, at any M): a
// mode of the w4 kernel below (K8/K9's). What bounds it is the weight bytes, (K/2)*N +
// 4*(K/g)*N per call (about 4 GB per Llama-3-8B decode step). The w4 mainloop streams them
// through a cp.async ring onto bf16 mma.sync with the batch as the 8-column operand, splits
// K across blocks from K, N and the SM count only (never M) and sums the splits in the
// block that arrives last. Per group: each warp accumulates its k-tiles of the current
// group into a temporary fragment (low and high half apart) and, where its group ends,
// adds tmp * scale[column] to its total. A group that is not a multiple of 16 rows may cut
// a k-tile: the tile then runs one masked MMA per group it touches (x rows outside the
// group zeroed in the operand), which is slower but takes any group dividing K/2.
//
// Regime B, prefill (M > 128 and a group that is a multiple of 16 rows): a tiled GEMM on
// wgmma. The operations bound it (2*M*K*N at 989 TFLOP/s), so the design feeds wgmma and
// dequantizes each weight once per 128-row batch tile:
// - A pre-pass writes x as bf16 (RN) in two planes (low half, high half), each (Mp, K/2)
//   with Mp = M rounded up to 128 and zero rows past M: one read and one write of x.
// - A block owns 128 batch rows x 128 columns. The weights are wgmma's register operand: two
//   consumer warpgroups of 64 columns each dequantize their packed bytes straight into the A
//   fragment (no bf16 weight tile in shared memory) and run m64n128k16 with the 128 batch
//   rows of x, from shared memory (K-major, 128-byte swizzle), as N.
// - The K loop runs per (group, half): for group gi, the low half's packed rows against x's
//   low plane, then the same packed rows' high nibbles against the high plane, in stages of
//   at most 128 packed rows that never cross a group. A producer warp brings each stage (the
//   x tile, the packed tile and the scale row) into a ring of four slots by TMA, guarded by
//   full/empty mbarriers; the consumer warpgroups never wait on each other, so one's
//   fragment building and promotion hide behind the other's wgmmas. Each consumer reads a
//   step's packed bytes one step ahead, so a wgmma is never held up by a shared-memory load.
// - Each warpgroup accumulates a (group, half) into a temporary set of 64 f32 registers
//   (its first wgmma overwrites it) and, where the (group, half) ends, adds tmp *
//   scale[column] into its total: the DeepGEMM-style promotion, in f32.
// - Blocks are rasterised in bands of 8 batch tiles, so a wave of blocks shares its x and
//   weight tiles in L2. No split-K: every output element is written once.
// What holds it back on an H100 (PERF.md, PR 6): each warpgroup's chain of fragment building
// and wgmma issue, and the L2 traffic of 128 x 128 tiles (x is read once per column tile);
// the two accumulator sets (total and tmp, 128 registers a thread) keep the tile at that size.

// Both regimes: every output element is summed in an order fixed by K, N, the group and
// (regime A) the card's SM count; no float atomics, so two calls give the same bits, and an
// MMA output element depends only on its own operand row and column, so a row's result does
// not depend on the rows that share its call (regime A), nor on them or on M among calls of
// regime B. The two regimes sum in different orders: the same row agrees across the
// boundary only within the tolerance.
//
// K8 and K9 replace micronet_tpu/ops/int4_matmul.py::int4_matmul and ::int4_matmul_grouped
// (Pallas bodies _kernel and _kernel_grouped) over the plain packing (pack_int4): packed
// row r holds weight row r in its low nibble, sign-extended as (b << 4) >> 4, and row
// K/2 + r in its high nibble, b >> 4 (arithmetic). Both run the low and the high half as
// two f32 sums (the Pallas split-K double dot) and add them at the end.
//   K8: out[m, n] = (sum_lo bf16(x) * q + sum_hi bf16(x) * q) * scale[n]: per-column
//       scales, applied once in the epilogue (after the K-split sum).
//   K9: out[m, n] = sum_lo bf16(x) * w + sum_hi bf16(x) * w, w = bf16(f32(q) * gscale),
//       each weight dequantized once, rounded to bf16, before the dot: its scale varies
//       along K (row r of the low half uses scale row r / g, of the high half K/(2g) + r / g;
//       g must divide K/2). Every product is exact in f32 (8-bit x 8-bit mantissas).
//
// What bounds K8/K9 (and K3's regime A): at decode (M <= 8) the weight bytes, (K/2)*N (+ the
// scales) per call. Their design (the w4 kernel below):
// - The product runs on the tensor cores, mma.sync m16n8k16 bf16 x bf16 -> f32, with A and B
//   swapped: 16 weight columns form the 16-row operand, x^T (8 batch rows, zero-padded) the
//   n = 8 operand. A block holds 8 or 16 batch rows (MB = 1 or 2 n-tiles); larger M takes
//   more blocks along grid.x, which share their weight tile through L2.
// - Bytes in flight: a block of 8 warps owns 128 columns and streams its packed rows, with
//   the x values of the same rows (f32, both halves), through a ring of shared-memory slots of
//   64 rows: 16-byte cp.async.cg (4-byte cp.async.ca where N % 16 != 0 or K % 8 != 0), six
//   slots (48 KB of weights) ahead at MB = 1, two blocks an SM. Warp (kw, cw) takes the 16-row
//   k-tile kw of every slot and the 64 columns cw: a K-split inside the block, reduced through
//   shared memory in kw order.
// - A K-split across blocks (splits from K, N and the card only, never from M: ops/
//   int4_matmul.py::_w4_splits) fills 132 SMs at N = 4096. Each split writes its partial
//   tile to a workspace; the block that arrives last (an int counter per output tile, reset
//   by that block) sums the splits in split order, applies K8's column scale and writes the
//   output. No float atomics, no second launch. (Summing the splits in a thread-block
//   cluster through distributed shared memory instead measured slower on an H100.)
// - Fragment mapping (no conversion instructions): within a 16-row k-tile, MMA k index 2t,
//   2t+1, 2t+8, 2t+9 (t = lane % 4) is packed row t, t+4, t+8, t+12; within a warp's 64
//   columns, MMA row g (g = lane / 4) of n-tile j is column 8g + 2j and row g + 8 is column
//   8g + 2j + 1. So each thread reads 8 contiguous bytes of 4 packed rows from shared memory
//   and holds, per n-tile, the two bytes of each row its fragment needs; its x fragment is read
//   at the same packed rows and rounded to bf16 there (cvt.rn.bf16x2.f32). Every output element
//   is still one column's dot over all of K, summed in an order fixed by K, N and the card.
// - Dequantize. K8: a byte permute puts the bytes of two packed rows side by side, then
//   ((v >> s) & 0x000F000F) ^ 0x43084308 is two bf16 128 + (q + 8), and one bf16x2 fma
//   subtracts 136: q exactly. K9: (nibble ^ 8) permuted into the mantissa of f32 2^23, minus
//   2^23 + 8, is q exactly; then one f32 multiply by the group scale and one rounding to bf16
//   per value (cvt.rn.bf16x2.f32 on pairs): the twin's bf16(f32(q) * gscale), so every
//   product is exact in f32.
// - The low and the high half run as two f32 accumulators, added where a warp's K slice
//   ends; a row's result does not depend on what shares its batch (an MMA output element
//   depends only on its own operand row and column, and the k order is fixed).
// - Diagnostic builds (tools/w4_variants.py, through ops/_build.py's defines): W4_NO_COMPUTE
//   keeps the copies and the split sum but no warp computes; W4_NO_REDUCE skips the split sum.

#include <cuda.h>  // CUtensorMap and its enums (the encoder is fetched at run time)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- the w4 kernel (K8, K9, K3 A)

constexpr int kW4Threads = 256;               // 8 warps: 4 k-slices x 2 column halves
constexpr int kW4BlockN = 128;                // columns per block
constexpr int kW4ColWarps = kW4BlockN / 64;   // a warp's columns: 4 MMA tiles of 16
constexpr int kW4KWarps = 8 / kW4ColWarps;    // a k-slice takes one 16-row k-tile of a slot
constexpr int kW4StageRows = 16 * kW4KWarps;  // packed rows per slot
constexpr int kW4Pitch = kW4BlockN + 32;      // bytes per staged weight row (conflict-free reads)
constexpr int kW4WBytes = kW4StageRows * kW4Pitch;
constexpr int kW4XPitch = kW4StageRows + 4;   // floats per staged x row (conflict-free reads)
// a ring slot: the weight tile, then x of both halves for 8 * MB batch rows
__host__ __device__ constexpr int w4_slot_bytes(int MB) {
  return kW4WBytes + 2 * 8 * MB * kW4XPitch * 4;
}
// ring depth: two blocks an SM at MB = 1 (102 KB each), one at MB = 2 (185 KB)
__host__ __device__ constexpr int w4_stages(int MB) { return MB == 1 ? 7 : 10; }
// the k-slices' partial tiles reuse the ring
static_assert(8 * 64 * 8 * 4 <= w4_stages(1) * w4_slot_bytes(1), "ring too small");
static_assert(8 * 64 * 16 * 4 <= w4_stages(2) * w4_slot_bytes(2), "ring too small");

// scales: K8's per column; K9's per group, a group a multiple of 16 rows (one k-tile in one
// group) or any group (each row's scale read where it is used); K3's per group applied to
// each group's partial dot, a group a multiple of 16 rows or any group (a k-tile cut by a
// group boundary runs one masked MMA per group it touches)
enum W4Mode { kW4Col = 0, kW4Group = 1, kW4GroupAny = 2, kW4Hl8 = 3, kW4Hl8Any = 4 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared copies of 16 or 4 bytes; src_bytes 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 128 + c (c < 16 at bits 0..3 and 16..19 of the argument) minus 136
__device__ __forceinline__ uint32_t minus136_bf16x2(uint32_t biased) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d) : "r"(biased), "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;
}

// K8 (and the hl8 high nibble): the two's complement nibbles at bits 0..3 and 16..19 of v as
// two exact bf16 codes: 0x4300 | (u ^ 8) is bf16 128 + (q + 8); minus 136 (0xC308) is q
__device__ __forceinline__ uint32_t dq_bf16x2(uint32_t v) {
  return minus136_bf16x2((v & 0x000F000Fu) ^ 0x43084308u);
}

// the hl8 low nibble, already q + 8: 0x4300 | u is bf16 128 + (q + 8); minus 136 is q
__device__ __forceinline__ uint32_t dq_hl8_lo_bf16x2(uint32_t v) {
  return minus136_bf16x2((v & 0x000F000Fu) | 0x43004300u);
}

// K9: byte kByte of v holds u ^ 8 (u a nibble); 0x4B0000vv is f32 2^23 + (q + 8), so
// subtracting 2^23 + 8 gives q exactly
template <int kByte>
__device__ __forceinline__ float q_f32(uint32_t v) {
  return __fadd_rn(__int_as_float(__byte_perm(v, 0x4B000000u, 0x7650 | kByte)), -8388616.0f);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  union { __nv_bfloat162 h; uint32_t u; } p;
  p.h = __floats2bfloat162_rn(lo, hi);  // .x (the low half) = lo
  return p.u;
}

// 8 consecutive scales from p (zeros past column N)
__device__ __forceinline__ void load8(float (&s)[8], const float* p, int col, int N) {
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (col + 4 * w < N) v = __ldg(reinterpret_cast<const float4*>(p + 4 * w));
    s[4 * w] = v.x; s[4 * w + 1] = v.y; s[4 * w + 2] = v.z; s[4 * w + 3] = v.w;
  }
}

// grid: x = batch tile of 8 * MB rows (fastest: blocks sharing a weight tile run together),
// y = column tile, z = K split (units of kW4StageRows packed rows). Dynamic shared memory: a
// ring of w4_stages(MB) slots, each the stage's weight bytes then its x values (f32).
template <int MB, int kMode, bool kVec16>
__global__ void __launch_bounds__(kW4Threads, MB == 1 ? 2 : 1)
w4_kernel(const float* __restrict__ x, const int8_t* __restrict__ packed,
          const float* __restrict__ scale, float* __restrict__ out, float* __restrict__ ws,
          int* __restrict__ counters, int M, int K, int N, int group, int splits) {
  constexpr int kRows = 8 * MB;
  constexpr int kStages = w4_stages(MB);
  constexpr int kSlot = w4_slot_bytes(MB);
  constexpr bool kHl8 = kMode == kW4Hl8 || kMode == kW4Hl8Any;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int last_block;
  const int k2 = K / 2;
  const int units = (k2 + kW4StageRows - 1) / kW4StageRows;
  const int u0 = (int)((long long)units * blockIdx.z / splits);
  const int nst = (int)((long long)units * (blockIdx.z + 1) / splits) - u0;
  const int row0 = u0 * kW4StageRows;
  const int m0 = blockIdx.x * kRows;
  const int col0 = blockIdx.y * kW4BlockN;
  const int tid = threadIdx.x;
  const bool x_vec = ((K | k2) & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;

  // stage st into its slot: the weight tile (rows past K/2 and columns past N as zeros), then
  // x of the stage's rows, both halves, as f32 [half][batch row][row] (zeros past M and K/2)
  auto load_stage = [&](int st) {
    uint8_t* dst = smem + (st % kStages) * kSlot;
    const int rb = row0 + st * kW4StageRows;
    constexpr int kBytes = kVec16 ? 16 : 4;
    constexpr int kPerRow = kW4BlockN / kBytes;
#pragma unroll
    for (int i = 0; i < kW4StageRows * kPerRow / kW4Threads; ++i) {
      const int idx = tid + i * kW4Threads;
      const int r = idx / kPerRow, c = (idx % kPerRow) * kBytes;
      const bool ok = rb + r < k2 && col0 + c < N;
      const int8_t* src = ok ? packed + (size_t)(rb + r) * N + col0 + c : packed;
      if (kVec16) cp_async16(dst + r * kW4Pitch + c, src, ok ? 16 : 0);
      else cp_async4(dst + r * kW4Pitch + c, src, ok ? 4 : 0);
    }
    float* xd = reinterpret_cast<float*>(dst + kW4WBytes);
    if (x_vec) {
      constexpr int kQuads = kW4StageRows / 4;
#pragma unroll
      for (int idx = tid; idx < 2 * kRows * kQuads; idx += kW4Threads) {
        const int hm = idx / kQuads, c = (idx % kQuads) * 4;
        const int m = m0 + hm % kRows;
        const bool ok = m < M && rb + c < k2;
        const float* src = ok ? x + (size_t)m * K + (hm / kRows) * k2 + rb + c : x;
        cp_async16(xd + hm * kW4XPitch + c, src, ok ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < 2 * kRows * kW4StageRows; idx += kW4Threads) {
        const int hm = idx / kW4StageRows, c = idx % kW4StageRows;
        const int m = m0 + hm % kRows;
        const bool ok = m < M && rb + c < k2;
        const float* src = ok ? x + (size_t)m * K + (hm / kRows) * k2 + rb + c : x;
        cp_async4(xd + hm * kW4XPitch + c, src, ok ? 4 : 0);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) load_stage(s);
    cp_async_commit();
  }

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kw = warp % kW4KWarps, cw = warp / kW4KWarps;
  const int my_col = col0 + cw * 64 + 8 * g;  // the first of this thread's 8 columns
  const int g1 = kMode == kW4Col ? 0 : k2 / group;
  // [batch n-tile][column n-tile][low, high half][fragment]; K3: the current group's partials
  float acc[MB][4][2][4] = {};
  float tot[MB][4][4] = {};  // K3: the promoted total, [batch][column n-tile][fragment]
  float sl[8], sh[8];  // K9, K3: this thread's columns' scales of the current group
  int next_group_row = 0;
  int cur_group = -1;  // K3: the group acc holds (warp-uniform)

  // K3: acc into tot, each half times its column's scale (fragment e is column 8g + 2j + e / 2)
  auto promote = [&]() {
#pragma unroll
    for (int b = 0; b < MB; ++b)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          tot[b][j][e] = __fmaf_rn(acc[b][j][0][e], sl[2 * j + e / 2], tot[b][j][e]);
          tot[b][j][e] = __fmaf_rn(acc[b][j][1][e], sh[2 * j + e / 2], tot[b][j][e]);
          acc[b][j][0][e] = acc[b][j][1][e] = 0.f;
        }
  };
  auto open_group = [&](int gi) {
    if (gi == cur_group) return;
    if (cur_group >= 0) promote();
    cur_group = gi;
    load8(sl, scale + (size_t)gi * N + my_col, my_col, N);
    load8(sh, scale + (size_t)(g1 + gi) * N + my_col, my_col, N);
  };

  for (int st = 0; st < nst; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage st landed for all; the slot refilled below was read by all
    if (st + kStages - 1 < nst) load_stage(st + kStages - 1);
    cp_async_commit();
    const int kb = row0 + st * kW4StageRows + kw * 16;  // this warp's k-tile
#ifdef W4_NO_COMPUTE
    continue;  // diagnostic build: the copies alone
#endif
    if (kb >= k2) continue;  // warp-uniform: a tile of zeros
    const uint8_t* slot = smem + (st % kStages) * kSlot;
    const uint8_t* wsm = slot + (kw * 16 + t) * kW4Pitch + cw * 64 + 8 * g;
    uint2 wr[4];  // packed rows t + 4i, this thread's 8 columns
#pragma unroll
    for (int i = 0; i < 4; ++i) wr[i] = *reinterpret_cast<const uint2*>(wsm + 4 * i * kW4Pitch);
    // x fragments: batch row 8b + g; b0 = rows (t, t + 4), b1 = rows (t + 8, t + 12)
    const float* xsm = reinterpret_cast<const float*>(slot + kW4WBytes) + kw * 16 + t;
    uint32_t bl[MB][2], bh[MB][2];
#pragma unroll
    for (int b = 0; b < MB; ++b) {
      const float* xl = xsm + (8 * b + g) * kW4XPitch;
      const float* xh = xl + kRows * kW4XPitch;
      bl[b][0] = pack_bf16x2(xl[0], xl[4]);
      bl[b][1] = pack_bf16x2(xl[8], xl[12]);
      bh[b][0] = pack_bf16x2(xh[0], xh[4]);
      bh[b][1] = pack_bf16x2(xh[8], xh[12]);
    }
    if (kMode == kW4Col || kHl8) {
      // the tile's codes against x fragments masked by mk0 (rows t, t + 4) and mk1 (rows
      // t + 8, t + 12): K3's masked MMA zeroes x rows outside a group; all ones elsewhere
      auto mma_tile = [&](uint32_t mk0, uint32_t mk1) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // bytes of columns 2j, 2j+1 of rows (0, 1) and (2, 3), side by side
          const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;
          const uint32_t t01 =
              __byte_perm(j < 2 ? wr[0].x : wr[0].y, j < 2 ? wr[1].x : wr[1].y, sel);
          const uint32_t t23 =
              __byte_perm(j < 2 ? wr[2].x : wr[2].y, j < 2 ? wr[3].x : wr[3].y, sel);
          uint32_t alo[4];
          if (kHl8) {
            alo[0] = dq_hl8_lo_bf16x2(t01); alo[1] = dq_hl8_lo_bf16x2(t01 >> 8);
            alo[2] = dq_hl8_lo_bf16x2(t23); alo[3] = dq_hl8_lo_bf16x2(t23 >> 8);
          } else {
            alo[0] = dq_bf16x2(t01); alo[1] = dq_bf16x2(t01 >> 8);
            alo[2] = dq_bf16x2(t23); alo[3] = dq_bf16x2(t23 >> 8);
          }
          const uint32_t ahi[4] = {dq_bf16x2(t01 >> 4), dq_bf16x2(t01 >> 12),
                                   dq_bf16x2(t23 >> 4), dq_bf16x2(t23 >> 12)};
#pragma unroll
          for (int b = 0; b < MB; ++b) {
            mma_bf16(acc[b][j][0], alo, bl[b][0] & mk0, bl[b][1] & mk1);
            mma_bf16(acc[b][j][1], ahi, bh[b][0] & mk0, bh[b][1] & mk1);
          }
        }
      };
      if (kMode == kW4Hl8Any) {
        // every group the tile touches, in order: rows [gi * group, (gi + 1) * group)
        const int g_last = min(kb + 15, k2 - 1) / group;
        for (int gi = kb / group; gi <= g_last; ++gi) {
          open_group(gi);
          const int lo = gi * group - kb, hi = lo + group;  // the group's rows, from kb
          const auto in = [&](int r) { return r >= lo && r < hi; };
          mma_tile((in(t) ? 0xFFFFu : 0u) | (in(t + 4) ? 0xFFFF0000u : 0u),
                   (in(t + 8) ? 0xFFFFu : 0u) | (in(t + 12) ? 0xFFFF0000u : 0u));
        }
      } else {
        if (kMode == kW4Hl8) open_group(kb / group);  // the tile lies in one group
        mma_tile(0xFFFFFFFFu, 0xFFFFFFFFu);
      }
    } else {
      const float* srow[4] = {nullptr, nullptr, nullptr, nullptr};  // kW4GroupAny: row i's
      if (kMode == kW4Group) {
        if (kb >= next_group_row) {  // a group starts (or this split does)
          const int gi = kb / group;
          next_group_row = (gi + 1) * group;
          load8(sl, scale + (size_t)gi * N + my_col, my_col, N);
          load8(sh, scale + (size_t)(g1 + gi) * N + my_col, my_col, N);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (kb + t + 4 * i < k2) srow[i] = scale + (size_t)((kb + t + 4 * i) / group) * N;
      }
      // the low half, then the high half: fewer values live at once
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t v[4][2];  // nibble ^ 8 in each byte, rows t + 4i, columns 0-3 and 4-7
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[i][0] = ((h ? wr[i].x >> 4 : wr[i].x) & 0x0F0F0F0Fu) ^ 0x08080808u;
          v[i][1] = ((h ? wr[i].y >> 4 : wr[i].y) & 0x0F0F0F0Fu) ^ 0x08080808u;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float w[4][2];  // [row i][column 2j + e], rounded to bf16 once, in pack_bf16x2
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 2 * j + e;
              float s;
              if (kMode == kW4Group) {
                s = h ? sh[c] : sl[c];
              } else {
                const bool ok = srow[i] != nullptr && my_col + c < N;
                s = ok ? __ldg(srow[i] + (size_t)h * g1 * N + my_col + c) : 0.f;
              }
              const uint32_t word = v[i][j >> 1];
              const int byte = 2 * (j & 1) + e;  // constant once unrolled
              const float q = byte == 0 ? q_f32<0>(word)
                              : byte == 1 ? q_f32<1>(word)
                              : byte == 2 ? q_f32<2>(word) : q_f32<3>(word);
              w[i][e] = __fmul_rn(q, s);
            }
          }
          const uint32_t a[4] = {pack_bf16x2(w[0][0], w[1][0]), pack_bf16x2(w[0][1], w[1][1]),
                                 pack_bf16x2(w[2][0], w[3][0]), pack_bf16x2(w[2][1], w[3][1])};
#pragma unroll
          for (int b = 0; b < MB; ++b)
            mma_bf16(acc[b][j][h], a, h ? bh[b][0] : bl[b][0], h ? bh[b][1] : bl[b][1]);
        }
      }
    }
  }
  if (kHl8 && cur_group >= 0) promote();
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the k-slices' partial tiles now

  // each warp's sums (K8/K9: low + high; K3: its promoted total); fragment c[e2] is column
  // 8g + 2j, batch row 2t + e2, and c[2 + e2] column 8g + 2j + 1
  float* red = reinterpret_cast<float*>(smem);  // [kw][cw][kRows][64]
#pragma unroll
  for (int b = 0; b < MB; ++b)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (kHl8) {
          v[2 * j] = tot[b][j][e2];
          v[2 * j + 1] = tot[b][j][2 + e2];
        } else {
          v[2 * j] = __fadd_rn(acc[b][j][0][e2], acc[b][j][1][e2]);
          v[2 * j + 1] = __fadd_rn(acc[b][j][0][2 + e2], acc[b][j][1][2 + e2]);
        }
      }
      float* dst = red + ((kw * kW4ColWarps + cw) * kRows + 8 * b + 2 * t + e2) * 64 + 8 * g;
      reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  __syncthreads();

  // the block's tile: the k-slices summed in kw order. With one split it is the output
  // (times K8's scale); with several, each split writes its tile to the workspace and the
  // last to arrive (an int counter per output tile, reset by that block) sums them in split
  // order
  constexpr int kQuads = kRows * kW4BlockN / 4;
  auto store = [&](int m, int n, float4 s) {
    if (kMode == kW4Col) {
      const float4 cs = __ldg(reinterpret_cast<const float4*>(scale + n));
      s = make_float4(__fmul_rn(s.x, cs.x), __fmul_rn(s.y, cs.y), __fmul_rn(s.z, cs.z),
                      __fmul_rn(s.w, cs.w));
    }
    *reinterpret_cast<float4*>(out + (size_t)m * N + n) = s;
  };
  for (int q = tid; q < kQuads; q += kW4Threads) {
    const int row = q / (kW4BlockN / 4), c4 = (q % (kW4BlockN / 4)) * 4;
    const int m = m0 + row, n = col0 + c4;
    if (m >= M || n >= N) continue;
    const float* src = red + (c4 / 64 * kRows + row) * 64 + c4 % 64;
    float4 s = *reinterpret_cast<const float4*>(src);
#pragma unroll
    for (int k = 1; k < kW4KWarps; ++k)
      s = add4(s, *reinterpret_cast<const float4*>(src + k * kW4ColWarps * kRows * 64));
    if (splits == 1) store(m, n, s);
    else __stcg(reinterpret_cast<float4*>(ws + ((size_t)blockIdx.z * M + m) * N + n), s);
  }
  if (splits == 1) return;
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
#ifdef W4_NO_REDUCE
  if (tid == 0) last_block = 0;  // diagnostic build: no split sum (split calls are wrong)
#else
  if (tid == 0) last_block = atomicAdd(counters + tile, 1) == splits - 1;
#endif
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  for (int q = tid; q < kQuads; q += kW4Threads) {
    const int row = q / (kW4BlockN / 4), c4 = (q % (kW4BlockN / 4)) * 4;
    const int m = m0 + row, n = col0 + c4;
    if (m >= M || n >= N) continue;
    float4 s = __ldcg(reinterpret_cast<const float4*>(ws + (size_t)m * N + n));
    for (int k = 1; k < splits; ++k)
      s = add4(s, __ldcg(reinterpret_cast<const float4*>(ws + ((size_t)k * M + m) * N + n)));
    store(m, n, s);
  }
  if (tid == 0) counters[tile] = 0;  // ready for the next call on this stream
}

// raise a kernel's dynamic shared-memory limit, once per device (allowed: the caller's flags,
// one set per kernel instantiation)
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, int bytes, bool (&allowed)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !allowed[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    if (dev < 64) allowed[dev] = true;
  }
  return cudaSuccess;
}

template <int MB, int kMode, bool kVec16>
int w4_launch(const void* x, const void* packed, const void* scale, void* out, void* ws,
              void* counters, int M, int K, int N, int group, int splits, cudaStream_t st) {
  constexpr int kSmem = w4_stages(MB) * w4_slot_bytes(MB);
  auto kern = w4_kernel<MB, kMode, kVec16>;
  static bool allowed[64] = {};
  cudaError_t e = allow_smem(kern, kSmem, allowed);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + 8 * MB - 1) / (8 * MB), (N + kW4BlockN - 1) / kW4BlockN, splits);
  kern<<<grid, kW4Threads, kSmem, st>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(packed),
      static_cast<const float*>(scale), static_cast<float*>(out), static_cast<float*>(ws),
      static_cast<int*>(counters), M, K, N, group, splits);
  return (int)cudaGetLastError();
}

template <int kMode>
int w4_dispatch(const void* x, const void* packed, const void* scale, void* out, void* ws,
                void* counters, int M, int K, int N, int group, int splits, int mb,
                void* stream) {
  const int k2 = K / 2;
  const int units = (k2 + kW4StageRows - 1) / kW4StageRows;
  if (M <= 0 || K <= 0 || K % 2 || N <= 0 || N % 4 || (N + kW4BlockN - 1) / kW4BlockN > 65535 ||
      splits < 1 || splits > units || (mb != 1 && mb != 2) ||
      (splits > 1 && (ws == nullptr || counters == nullptr)) ||
      (kMode != kW4Col && (group <= 0 || k2 % group)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool vec16 = N % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  if (mb == 1)
    return vec16 ? w4_launch<1, kMode, true>(x, packed, scale, out, ws, counters, M, K, N, group,
                                             splits, st)
                 : w4_launch<1, kMode, false>(x, packed, scale, out, ws, counters, M, K, N,
                                              group, splits, st);
  return vec16 ? w4_launch<2, kMode, true>(x, packed, scale, out, ws, counters, M, K, N, group,
                                           splits, st)
               : w4_launch<2, kMode, false>(x, packed, scale, out, ws, counters, M, K, N, group,
                                            splits, st);
}

// ---------------------------------------------------------------- K3 regime B: the wgmma GEMM

constexpr int kGbM = 128;        // batch rows a block: N of m64n128k16
constexpr int kGbN = 128;        // columns a block: two warpgroups' 64 A rows
constexpr int kGbK = 128;        // packed rows a stage at most (two 128-byte swizzle atoms of x)
constexpr int kGbStages = 4;     // ring slots
constexpr int kGbRaster = 8;     // batch tiles in a band of the block order
constexpr int kGbXBytes = kGbM * kGbK * 2;  // a stage's x tile, bf16, [atom][row][128 bytes]
constexpr int kGbWBytes = kGbK * kGbN;      // its packed tile, [row][128 bytes]
constexpr int kGbSBytes = kGbN * 4;         // its scale row
constexpr int kGbSlot = (kGbXBytes + kGbWBytes + kGbSBytes + 1023) / 1024 * 1024;
constexpr int kGbSmem = 1024 + kGbStages * kGbSlot + 2 * kGbStages * 8;  // + alignment, barriers
static_assert(kGbSmem <= 232448, "regime B's shared memory exceeds a block's");
constexpr int kGbConsumers = 2 * 128;           // two warpgroups: wgmma
constexpr int kGbThreads = kGbConsumers + 32;   // and one producer warp: the loads

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending) : "memory");
}
// keeps the compiler from moving accesses of an accumulator across a wgmma fence or wait
__device__ __forceinline__ void reg_fence(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// the descriptor of a K-major bf16 tile with the 128-byte swizzle: rows of 128 bytes (64
// values of K), 8-row groups 1024 bytes apart; the tile's base 1024-byte aligned, a k16 step
// 32 bytes further on
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// d (64 f32 a thread) = [d +] A (64 x 16 bf16, in registers: this thread's fragment a) * B
// (16 x 128, K-major, 128-byte swizzle, from shared memory through its descriptor)
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// x (M, K) f32 -> xb (2, Mp, K/2) bf16 (RN): plane h holds x[:, h*K/2 : (h+1)*K/2], rows past
// M zero. K/2 % 8 == 0; each thread writes 8 values (16 bytes) at a time.
__global__ void hl8_x_bf16_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ xb,
                                  int M, int Mp, int K) {
  const int k2 = K / 2, cpr = k2 / 8;
  const long long total = 2LL * Mp * cpr;
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0 && K % 4 == 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % cpr);
    const long long hm = i / cpr;
    const int m = (int)(hm % Mp), h = (int)(hm / Mp);
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (m < M) {
      const float* src = x + (size_t)m * K + (size_t)h * k2 + 8 * c;
      if (vec) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(src));
        const float4 b = __ldg(reinterpret_cast<const float4*>(src + 4));
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = __ldg(src + e);
      }
    }
    *reinterpret_cast<uint4*>(xb + hm * k2 + 8 * c) =
        make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]), pack_bf16x2(v[4], v[5]),
                   pack_bf16x2(v[6], v[7]));
  }
}

// ---- mbarrier and TMA primitives

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}
// the barrier counts one arrival once all of this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(smem_addr(bar))
               : "memory");
}
// wait for the phase of parity `parity` to complete; a phase that never completes traps
// (after about 2^35 cycles) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    if (clock64() - t0 > (1LL << 35)) __trap();
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}
// a 2-D TMA tile load into this CTA's shared memory, counted by `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
         "r"(c1) : "memory");
}

// (group, half, sub-stage) of consecutive stages, without divisions: the sub-stages of a
// group's low half, then of its high half, then the next group
struct StageWalk {
  int gi = 0, h = 0, s = 0;
  __device__ __forceinline__ void next(int nsub) {
    if (++s == nsub) {
      s = 0;
      if (++h == 2) { h = 0; ++gi; }
    }
  }
};

// One block: 128 batch rows x 128 columns of out, over all of K, in stages of at most kGbK
// packed rows of one (group, half). Warps 0-7 are two consumer warpgroups: warpgroup c owns
// the columns 64c..64c+63 as wgmma's register operand A (warp w: columns 16w + 2g and
// 16w + 2g + 1 as A rows g and g + 8, g = lane / 4), the 128 batch rows as N, x from shared
// memory (the B operand). Warp 8 is the producer: per stage, lane 0 brings the x tile, the
// packed tile (128-byte swizzle: chunk c of row r at c ^ (r % 8)) and the scale row by TMA
// (where N % 16 != 0 the packed tile and scales come by cp.async from all 32 lanes). Slot s is
// guarded by full[s] (lane 0's expect_tx arrival and the bytes, with the lanes' cp.async
// arrivals on that path) and empty[s] (an arrival from every consumer thread once its wgmmas on
// the slot are done). The warpgroups never wait on each other, so one's fragment building,
// promotion and waits hide behind the other's wgmmas.
template <bool kVec16>
__global__ void __launch_bounds__(kGbThreads, 1)
hl8_gemm_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                const __grid_constant__ CUtensorMap smap, const int8_t* __restrict__ packed,
                const float* __restrict__ scale, float* __restrict__ out, int M, int Mp, int K,
                int N, int group) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kGbStages * kGbSlot);
  uint64_t* empty = full + kGbStages;
  const int k2 = K / 2, g1 = k2 / group;
  const int nsub = (group + kGbK - 1) / kGbK, nv = g1 * 2 * nsub;
  // the block's tile: bands of kGbRaster batch tiles, column tiles across a band
  const int num_m = Mp / kGbM, num_n = (N + kGbN - 1) / kGbN;
  const int band = blockIdx.x / (kGbRaster * num_n);
  const int first_m = band * kGbRaster;
  const int band_m = min(num_m - first_m, kGbRaster);
  const int in_band = blockIdx.x % (kGbRaster * num_n);
  const int m0 = (first_m + in_band % band_m) * kGbM, n0 = in_band / band_m * kGbN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < kGbStages; ++s) {
      mbar_init(full + s, kVec16 ? 1 : 33);  // lane 0's expect_tx (and 32 cp.async arrivals)
      mbar_init(empty + s, kGbConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kGbConsumers / 32) {  // the producer warp
    StageWalk w;
    for (int v = 0; v < nv; ++v, w.next(nsub)) {
      const int slot_i = v % kGbStages;
      if (v >= kGbStages) mbar_wait(empty + slot_i, (v / kGbStages - 1) & 1);
      uint8_t* slot = ring + slot_i * kGbSlot;
      uint8_t* wd = slot + kGbXBytes;
      const int r0 = w.gi * group + w.s * kGbK;
      const int srow = w.h ? g1 + w.gi : w.gi;
      if (lane == 0) {  // rows past the stage, K/2 or N arrive too (zeros past the edges)
        mbar_expect_tx(full + slot_i, kVec16 ? kGbXBytes + kGbWBytes + kGbSBytes : kGbXBytes);
#pragma unroll
        for (int a = 0; a < kGbK / 64; ++a)
          tma_load(slot + a * kGbM * 128, &xmap, full + slot_i, r0 + 64 * a, w.h * Mp + m0);
        if (kVec16) {
          tma_load(wd, &wmap, full + slot_i, n0, r0);
          tma_load(wd + kGbWBytes, &smap, full + slot_i, n0, srow);
        }
      }
      if (kVec16) continue;
      const int rows = min(kGbK, group - w.s * kGbK);
      const int8_t* wp = packed + (size_t)r0 * N + n0;
      for (int idx = lane; idx < kGbK * 32; idx += 32) {
        const int r = idx >> 5, c = (idx & 31) * 4;
        const bool ok = r < rows && n0 + c < N;
        cp_async4(wd + r * kGbN + ((((c >> 4) ^ (r & 7)) << 4) | (c & 15)),
                  ok ? wp + (size_t)r * N + c : packed, ok ? 4 : 0);
      }
      const bool ok = n0 + 4 * lane < N;  // the scale row, zeros past N
      cp_async16(wd + kGbWBytes + 16 * lane, ok ? scale + (size_t)srow * N + n0 + 4 * lane : scale,
                 ok ? 16 : 0);
      cp_async_mbar_arrive(full + slot_i);
    }
    return;
  }

  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int c0 = wg * 64 + (warp & 3) * 16 + 2 * g;  // this thread's columns c0, c0 + 1
  // the packed bytes of k16 step i this thread's fragment needs: columns (c0, c0 + 1) of rows
  // 2t, 2t + 1, 2t + 8, 2t + 9 of the step (four 16-bit reads, four chunk slots: no conflict)
  auto raw = [&](uint32_t (&u)[4], const uint8_t* wsm, int i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = 16 * i + 2 * t + (q & 1) + 8 * (q >> 1);
      u[q] = *reinterpret_cast<const uint16_t*>(wsm + r * kGbN + (((c0 >> 4) ^ (r & 7)) << 4) +
                                                (c0 & 15));
    }
  };
  // ... dequantized into the fragment: A rows g, g + 8 = columns c0, c0 + 1; k pairs
  // (2t, 2t + 1) and (2t + 8, 2t + 9)
  auto fragment = [&](uint32_t (&a)[4], const uint32_t (&u)[4], int h) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const uint32_t v0 = __byte_perm(u[2 * p], u[2 * p + 1], 0x4400);  // column c0
      const uint32_t v1 = __byte_perm(u[2 * p], u[2 * p + 1], 0x5511);  // column c0 + 1
      a[2 * p] = h ? dq_bf16x2(v0 >> 4) : dq_hl8_lo_bf16x2(v0);
      a[2 * p + 1] = h ? dq_bf16x2(v1 >> 4) : dq_hl8_lo_bf16x2(v1);
    }
  };
  float acc[64], tmp[64];  // the total; the current (group, half)'s partials
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = tmp[i] = 0.f;

  StageWalk w;
  for (int v = 0; v < nv; ++v, w.next(nsub)) {
    const int slot_i = v % kGbStages;
    const uint8_t* slot = ring + slot_i * kGbSlot;
    const bool first = w.s == 0, last = w.s == nsub - 1;
    const int steps = min(kGbK, group - w.s * kGbK) / 16;
    mbar_wait(full + slot_i, (v / kGbStages) & 1);
    const uint32_t b = smem_addr(slot);
    // the k16 steps: the wgmma of step i runs while the fragment of step i + 1 is built from
    // bytes read during step i - 1; a (group, half)'s first wgmma overwrites tmp
    uint32_t a[2][4], u[4];
    raw(u, slot + kGbXBytes, 0);
    fragment(a[0], u, w.h);
    if (steps > 1) raw(u, slot + kGbXBytes, 1);
#pragma unroll
    for (int i = 0; i < kGbK / 16; ++i) {
      if (i >= steps) break;
      reg_fence(tmp);
      wgmma_fence();
      wgmma_rs_m64n128k16(tmp, a[i & 1], sw128_desc(b + (i >> 2) * kGbM * 128 + 32 * (i & 3)),
                          i > 0 || !first);
      wgmma_commit();
      reg_fence(tmp);
      if (i + 1 < steps) {
        wgmma_wait<1>();  // step i - 1 done: its fragment registers are free
        fragment(a[(i + 1) & 1], u, w.h);
        if (i + 2 < steps) raw(u, slot + kGbXBytes, i + 2);  // lands while step i runs
      }
    }
    wgmma_wait<0>();
    reg_fence(tmp);
    if (last) {  // the (group, half) ends: tmp into acc, times its scale at this thread's columns
      const float2 sc = *reinterpret_cast<const float2*>(slot + kGbXBytes + kGbWBytes + 4 * c0);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        acc[4 * j] = __fmaf_rn(tmp[4 * j], sc.x, acc[4 * j]);
        acc[4 * j + 1] = __fmaf_rn(tmp[4 * j + 1], sc.x, acc[4 * j + 1]);
        acc[4 * j + 2] = __fmaf_rn(tmp[4 * j + 2], sc.y, acc[4 * j + 2]);
        acc[4 * j + 3] = __fmaf_rn(tmp[4 * j + 3], sc.y, acc[4 * j + 3]);
      }
    }
    mbar_arrive(empty + slot_i);  // this thread is done with the slot
  }

  // fragment 4j + e: weight column c0 + e / 2, batch row 8j + 2t + e % 2
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = n0 + c0;
    const int m = m0 + 8 * j + 2 * t;
    if (n >= N) continue;
    if (m < M)
      *reinterpret_cast<float2*>(out + (size_t)m * N + n) = make_float2(acc[4 * j], acc[4 * j + 2]);
    if (m + 1 < M)
      *reinterpret_cast<float2*>(out + (size_t)(m + 1) * N + n) =
          make_float2(acc[4 * j + 1], acc[4 * j + 3]);
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the tensor maps of the x planes (2 * Mp rows of K/2 bf16; a box of 64 values, one swizzle
// atom, x 128 rows), of packed ((K/2, N) bytes; a box of 128 columns x kGbK rows, 128-byte
// swizzle) and of gscale ((K/group, N) f32; a box of 128 columns x 1 row), then the GEMM. TMA
// needs 16-byte row strides: packed's and gscale's maps only where N % 16 == 0 (kVec16)
template <bool kVec16>
int hl8_gemm_launch(const __nv_bfloat16* xb, const int8_t* packed, const float* scale, float* out,
                    int M, int Mp, int K, int N, int group, int tiles, cudaStream_t st) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const int k2 = K / 2;
  const cuuint32_t elem[2] = {1, 1};
  CUtensorMap xmap, wmap, smap;
  const cuuint64_t xdims[2] = {(cuuint64_t)k2, (cuuint64_t)2 * Mp};
  const cuuint64_t xstrides[1] = {(cuuint64_t)k2 * 2};
  const cuuint32_t xbox[2] = {64, kGbM};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<__nv_bfloat16*>(xb), xdims,
             xstrides, xbox, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  wmap = smap = xmap;  // unused without kVec16
  if (kVec16) {
    const cuuint64_t wdims[2] = {(cuuint64_t)N, (cuuint64_t)k2};
    const cuuint64_t wstrides[1] = {(cuuint64_t)N};
    const cuuint32_t wbox[2] = {kGbN, kGbK};
    const cuuint64_t sdims[2] = {(cuuint64_t)N, (cuuint64_t)(K / group)};
    const cuuint64_t sstrides[1] = {(cuuint64_t)N * 4};
    const cuuint32_t sbox[2] = {kGbN, 1};
    if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(packed), wdims,
               wstrides, wbox, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
            CUDA_SUCCESS ||
        encode(&smap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(scale), sdims,
               sstrides, sbox, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  auto kern = hl8_gemm_kernel<kVec16>;
  static bool allowed[64] = {};
  cudaError_t e = allow_smem(kern, kGbSmem, allowed);
  if (e != cudaSuccess) return (int)e;
  kern<<<tiles, kGbThreads, kGbSmem, st>>>(xmap, wmap, smap, packed, scale, out, M, Mp, K, N,
                                           group);
  return (int)cudaGetLastError();
}

}  // namespace

// K3, regime A (ops/int4_matmul.py::_k3_regime): x (M, K) f32, packed (K/2, N) int8 hl8,
// gscale (K/group, N) f32 (16-byte aligned), out (M, N) f32; group divides K/2. splits and
// mb and the workspace conventions as K8's (below).
extern "C" int mn_int4_matmul_grouped_hl8(const void* x, const void* packed, const void* gscale,
                                          void* out, void* ws, void* counters, int M, int K,
                                          int N, int group, int splits, int mb, void* stream) {
  if (group > 0 && group % 16 == 0)
    return w4_dispatch<kW4Hl8>(x, packed, gscale, out, ws, counters, M, K, N, group, splits, mb,
                               stream);
  return w4_dispatch<kW4Hl8Any>(x, packed, gscale, out, ws, counters, M, K, N, group, splits,
                                mb, stream);
}

// K3, regime B: as regime A, with group % 16 == 0; xb is a scratch of 2 * Mp * K/2 bf16, Mp =
// M rounded up to 128. Two launches: the bf16 pre-pass of x, then the GEMM.
extern "C" int mn_int4_matmul_grouped_hl8_gemm(const void* x, const void* packed,
                                               const void* gscale, void* out, void* xb, int M,
                                               int K, int N, int group, void* stream) {
  const int k2 = K / 2;
  const int Mp = (M + kGbM - 1) / kGbM * kGbM;
  const long long tiles = (long long)(Mp / kGbM) * ((N + kGbN - 1) / kGbN);
  if (M <= 0 || K <= 0 || K % 2 || N <= 0 || N % 4 || group <= 0 || group % 16 ||
      k2 % group || tiles > 0x7FFFFFFF || xb == nullptr ||
      reinterpret_cast<uintptr_t>(xb) % 16 || reinterpret_cast<uintptr_t>(gscale) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  __nv_bfloat16* xbf = static_cast<__nv_bfloat16*>(xb);
  const long long chunks = 2LL * Mp * (k2 / 8);
  const int blocks = (int)((chunks + 255) / 256 < 4096 ? (chunks + 255) / 256 : 4096);
  hl8_x_bf16_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(x), xbf, M, Mp, K);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int8_t* wp = static_cast<const int8_t*>(packed);
  const float* gs = static_cast<const float*>(gscale);
  float* o = static_cast<float*>(out);
  if (N % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0)
    return hl8_gemm_launch<true>(xbf, wp, gs, o, M, Mp, K, N, group, (int)tiles, st);
  return hl8_gemm_launch<false>(xbf, wp, gs, o, M, Mp, K, N, group, (int)tiles, st);
}

// K8: x (M, K) f32, packed (K/2, N) int8 (pack_int4), scale (N,) f32, out (M, N) f32.
// splits (the K-split, from ops/int4_matmul.py::_w4_splits) and mb (1 for M <= 8, else 2:
// batch rows of a block / 8) come from the wrapper. With splits > 1, ws is a (splits, M, N)
// f32 scratch and counters holds one zeroed int per output tile (batch tiles x column
// tiles), left zeroed again; with splits == 1 both are unused.
extern "C" int mn_int4_matmul(const void* x, const void* packed, const void* scale, void* out,
                              void* ws, void* counters, int M, int K, int N, int splits, int mb,
                              void* stream) {
  return w4_dispatch<kW4Col>(x, packed, scale, out, ws, counters, M, K, N, 0, splits, mb,
                             stream);
}

// K9: as K8 with gscale (K/group, N) f32; group must divide K/2.
extern "C" int mn_int4_matmul_grouped(const void* x, const void* packed, const void* gscale,
                                      void* out, void* ws, void* counters, int M, int K, int N,
                                      int group, int splits, int mb, void* stream) {
  if (group > 0 && group % 16 == 0)
    return w4_dispatch<kW4Group>(x, packed, gscale, out, ws, counters, M, K, N, group, splits,
                                 mb, stream);
  return w4_dispatch<kW4GroupAny>(x, packed, gscale, out, ws, counters, M, K, N, group, splits,
                                  mb, stream);
}
