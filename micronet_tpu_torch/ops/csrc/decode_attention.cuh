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
// oracles do not. Two regimes keep that:
//
// - one block per group (S <= 4096 in the wrappers): the group's R x (S+1)
//   logits stay in shared memory; three passes: logits, softmax, weighted sum;
// - split S (S > 4096): the positions are cut into splits of kSplit (the last
//   split also holds position S, where a current row may sit), one block per
//   (group, split). Pass 1 writes each split's logits to a global scratch and
//   its max; pass 2 takes the group's max over all splits, forms p and
//   bf16(p * v_scale) for its split and writes partial sums; a last kernel adds
//   the partials in split order. A split wholly past the bound writes zeros and
//   computes no exp. The split count depends on S only.
//
// Row addressing is a template parameter (DenseRows, PagedRows), so a paged
// pool and the dense view gathered from it run the same instructions in the
// same order: bit for bit equal results. A group's sums run in an order fixed
// by S, its bound and the thread layout, never by the number of groups, so a
// result does not depend on the batch.
//
// What bounds them: bytes. Per group they read bound * (2 * D + 8) bytes of
// codes and scales once each and do about 4 * R * D operations per position,
// far below the card's operations-per-byte ratio. A warp takes one position at
// a time, each lane reading 4 codes with one 32-bit load (a warp reads a whole
// 128-byte row) and the position's scale with them, so a paged row's address
// is computed once; 4 positions in flight per warp. The split regime adds
// R * (S + 1) * 4 bytes of logits written and read back (a tenth of the codes
// at R = 4), and fills the card at G = 64 groups where one block per group
// leaves half of the 132 SMs idle.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace mn_attn {
namespace {  // internal to each library that includes this header

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;   // positions in flight per warp
constexpr int kMaxD = 128;   // 32 lanes x 4 codes
constexpr int kSplit = 512;  // positions per split (ops/decode_attention.py::_SPLIT)

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void unpack4(int w, float (&c)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = (float)(int8_t)((w >> (8 * i)) & 0xFF);
}

// Cache position s of group g is row `row(g, s)`: its codes start at row * D,
// its scale is element `row` of the scales.
struct DenseRows {
  const int* bound;  // (G,) positions < bound are visible
  int S;
  __device__ __forceinline__ int visible(int g) const { return bound[g]; }
  __device__ __forceinline__ size_t row(int g, int s) const { return (size_t)g * S + s; }
};

// Pool codes (P, H, page, D), scales (P, H, 1, page); group g = slot * H + h.
struct PagedRows {
  const int* table;    // (slots, MP) pool page of each logical page
  const int* lengths;  // (slots,) positions < lengths are visible
  int H, page, MP;
  __device__ __forceinline__ int visible(int g) const { return lengths[g / H]; }
  __device__ __forceinline__ size_t row(int g, int s) const {
    const int slot = g / H;
    const int lp = s / page;
    const int pg = __ldg(table + (size_t)slot * MP + lp);
    return ((size_t)pg * H + (g - slot * H)) * page + (s - lp * page);
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
// scale or a code behind the stores to shared memory before it (about 20 %
// slower for the one-block kernel).
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

// ---------------------------------------------------------------- one block per group

template <int R, bool CUR, class Rows>
__global__ void __launch_bounds__(kThreads) attend_block_kernel(Rows rows, MN_OPERAND_PARAMS) {
  MN_OPERANDS_IN_KERNEL;
  extern __shared__ float smem[];
  float* red = smem;                        // [kWarps][R][kMaxD]
  float* prob = smem + kWarps * R * kMaxD;  // [R][S + 1] logits, then bf16(p * vs)
  __shared__ float wmax[kWarps][R];
  __shared__ float wsum[kWarps][R];
  const int g = blockIdx.x;
  const int ld = op.S + 1;
  const int nb = cached_bound(rows, op, g);
  const int n = nb + (CUR ? 1 : 0);  // visible positions; `nb` is the current row
  float qv[R][4];
  load_q<R>(op, g, qv);
  float mx[R], m[R];
#pragma unroll
  for (int r = 0; r < R; ++r) mx[r] = -INFINITY;
  logits_pass<R, CUR>(rows, op, g, nb, 0, n, qv, prob, ld, mx);
  block_max<R>(mx, wmax, m);
  softmax_pass<R, CUR>(rows, op, g, nb, 0, n, prob, ld, prob, ld, m, wsum);
  __syncthreads();
  weighted_pass<R, CUR>(rows, op, g, nb, 0, n, prob, ld, red);
  for (int i = threadIdx.x; i < R * op.D; i += kThreads) {
    const int r = i / op.D, d = i - r * op.D;
    float den = wsum[0][r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) den += wsum[w][r];
    op.out[((size_t)g * R + r) * op.D + d] = warp_sum<R>(red, r, d) / fmaxf(den, 1e-30f);
  }
}

// ---------------------------------------------------------------- split S

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
  extern __shared__ float smem[];
  float* red = smem;                        // [kWarps][R][kMaxD]
  float* pvb = smem + kWarps * R * kMaxD;   // [R][kSplit + 1] bf16(p * vs)
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

// Floats of scratch the split regime needs (ops/decode_attention.py::_scratch_floats).
inline long long split_scratch_floats(int G, int S, int D, int R) {
  return (long long)G * R * ((long long)S + 1 + (long long)split_count(S) * (D + 2));
}

template <int R, bool CUR, class Rows>
cudaError_t launch(const Rows& rows, const Operands& op, int G, bool split, float* scratch,
                   cudaStream_t st) {
  cudaError_t err;
  if (!split) {
    const size_t bytes = sizeof(float) * ((size_t)kWarps * R * kMaxD + (size_t)R * (op.S + 1));
    err = cudaFuncSetAttribute(attend_block_kernel<R, CUR, Rows>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    attend_block_kernel<R, CUR, Rows><<<G, kThreads, bytes, st>>>(rows, MN_OPERAND_ARGS(op));
    return cudaGetLastError();
  }
  const int nsplit = split_count(op.S);
  float* lg = scratch;                                  // [G][R][S + 1]
  float* smax = lg + (size_t)G * R * (op.S + 1);        // [G][nsplit][R]
  float* pden = smax + (size_t)G * nsplit * R;          // [G][nsplit][R]
  float* pacc = pden + (size_t)G * nsplit * R;          // [G][nsplit][R][D]
  const dim3 grid(G, nsplit);
  split_logits_kernel<R, CUR, Rows><<<grid, kThreads, 0, st>>>(rows, MN_OPERAND_ARGS(op), lg,
                                                                smax, nsplit);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t bytes = sizeof(float) * ((size_t)kWarps * R * kMaxD + (size_t)R * (kSplit + 1));
  err = cudaFuncSetAttribute(split_values_kernel<R, CUR, Rows>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  split_values_kernel<R, CUR, Rows><<<grid, kThreads, bytes, st>>>(rows, MN_OPERAND_ARGS(op), lg,
                                                                   smax, pden, pacc, nsplit);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  split_combine_kernel<<<G, kThreads, 0, st>>>(pden, pacc, op.out, nsplit, R, op.D);
  return cudaGetLastError();
}

template <class Rows>
cudaError_t dispatch(const Rows& rows, const Operands& op, int G, int R, bool cur, bool split,
                     float* scratch, cudaStream_t st) {
#define MN_CASE(RR)                                                              \
  case RR:                                                                       \
    return cur ? launch<RR, true>(rows, op, G, split, scratch, st)               \
               : launch<RR, false>(rows, op, G, split, scratch, st);
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

// Checks shared by the entry points; true when the arguments are usable.
inline bool valid_args(int G, int S, int D, int R, bool split, const void* scratch,
                       long long scratch_floats) {
  if (G <= 0 || S <= 0 || D <= 0 || D > kMaxD || D % 4 || R < 1 || R > 8) return false;
  return !split || (scratch != nullptr && scratch_floats >= split_scratch_floats(G, S, D, R));
}

#undef MN_OPERAND_PARAMS
#undef MN_OPERANDS_IN_KERNEL
#undef MN_OPERAND_ARGS

}  // namespace
}  // namespace mn_attn
