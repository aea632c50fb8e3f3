// Decode attention over an int8 K/V cache, for Hopper (sm_90a).
//
// Replaces two TPU kernels of micronet_tpu/ops/decode_attention.py:
//   decode_attend_q8kv      (Pallas body _kernel)      -> CUR = false
//   decode_attend_q8kv_cur  (Pallas body _kernel_cur)  -> CUR = true
// and computes what their XLA oracles decode_attend_q8kv_xla and
// decode_attend_q8kv_cur_xla compute, for one KV group g per block:
//
//   logit[r, s] = (sum_d bf16(q[r, d]) * kc[s, d]) * ks[s] / sqrt(D)   s < bound
//   m[r]        = max_s logit[r, s]
//   p[r, s]     = exp(logit[r, s] - m[r])                  (0 where s >= bound)
//   out[r, :]   = (sum_s bf16(p[r, s] * vs[s]) * vc[s, :]) / max(sum_s p[r, s], 1e-30)
//
// With CUR the current token's int8 K/V row (kcur, kscur, vcur, vscur) is one
// more always-visible column, rounded exactly like a cached one. It is taken as
// position `bound` of the same loops, so K4a at bound b computes bit for bit
// what K5a computes at bound b + 1 over a cache whose row b holds that row: the
// serving loop's deferred append and the isolated append-then-attend agree.
//
// GQA: the R <= 8 query rows of a block are the query heads that share KV
// group g (query head i reads group i // R).
//
// Rounding points follow the oracles: the softmax takes the GLOBAL max before
// any exp, and p * v_scale is rounded to bf16 before the product with the codes.
// An online softmax would round p against a running max, which these oracles do
// not, so one block keeps its group's R x (S+1) logits in shared memory
// (R * (S + 1) * 4 bytes, about 32 KB at R = 4, S = 2048; dynamic shared memory
// above 48 KB) and makes three passes: logits, softmax, weighted sum.
//
// What bounds it: bytes. Per group it reads bound * (2 * D + 8) bytes of codes
// and scales once each and does 4 * R * D operations per position, far below
// the card's operations-per-byte ratio. Design for that: a warp takes one cache
// position at a time, each lane reading 4 codes with one 32-bit load (one warp
// reads a whole 128-byte row), 4 positions in flight per warp; the logits pass
// and the weighted-sum pass read each code once. Each position's dot is a fixed
// lane order plus a butterfly, and every sum over positions runs in an order
// fixed by (bound, thread layout), so results do not depend on the batch. One
// block per group (G = batch x KV heads = 64 at the 8B serving shape) leaves
// half the SMs idle: splitting S across blocks is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;  // positions in flight per warp
constexpr int kMaxD = 128;  // 32 lanes x 4 codes

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void unpack4(int w, float (&c)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = (float)(int8_t)((w >> (8 * i)) & 0xFF);
}

template <int R, bool CUR>
__global__ void __launch_bounds__(kThreads)
decode_attend_kernel(const int8_t* __restrict__ kc, const float* __restrict__ ks,
                     const int8_t* __restrict__ vc, const float* __restrict__ vs,
                     const float* __restrict__ q, const int* __restrict__ bound,
                     const int8_t* __restrict__ kcur, const float* __restrict__ kscur,
                     const int8_t* __restrict__ vcur, const float* __restrict__ vscur,
                     float* __restrict__ out, int S, int D) {
  extern __shared__ float smem[];
  float* red = smem;                        // [kWarps][R][kMaxD] weighted-sum partials
  float* prob = smem + kWarps * R * kMaxD;  // [R][S + 1] logits, then bf16(p * vs)
  __shared__ float wmax[kWarps][R];
  __shared__ float wsum[kWarps][R];

  const int g = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ld = S + 1;
  int nb = bound[g];
  nb = nb < 0 ? 0 : (nb > S ? S : nb);
  const int n = nb + (CUR ? 1 : 0);  // visible positions; `nb` is the current row
  const bool lane_on = lane * 4 < D;
  const size_t gs = (size_t)g * S;
  const float sqrt_d = sqrtf((float)D);

  float qv[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      qv[r][c] = lane_on ? bf16_round(q[((size_t)g * R + r) * D + lane * 4 + c]) : 0.f;

  // pass 1: logits
  for (int s0 = warp * kUnroll; s0 < n; s0 += kWarps * kUnroll) {
    int w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u;
      w[u] = 0;
      if (s < n && lane_on) {
        const int8_t* row = (CUR && s == nb) ? kcur + (size_t)g * D : kc + (gs + s) * D;
        w[u] = __ldg(reinterpret_cast<const int*>(row + lane * 4));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u;
      if (s >= n) break;
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
        const float sc = (CUR && s == nb) ? kscur[g] : ks[gs + s];
#pragma unroll
        for (int r = 0; r < R; ++r) prob[r * ld + s] = __fdiv_rn(part[r] * sc, sqrt_d);
      }
    }
  }
  __syncthreads();

  // pass 2: global max, p = exp(logit - max), denominator, bf16(p * v_scale)
  float mx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    mx[r] = -INFINITY;
    for (int s = threadIdx.x; s < n; s += kThreads) mx[r] = fmaxf(mx[r], prob[r * ld + s]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
    if (lane == 0) wmax[warp][r] = mx[r];
  }
  __syncthreads();
  float sum[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float m = wmax[0][r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, wmax[w][r]);
    sum[r] = 0.f;
    for (int s = threadIdx.x; s < n; s += kThreads) {
      const float p = expf(prob[r * ld + s] - m);
      sum[r] += p;
      const float vsc = (CUR && s == nb) ? vscur[g] : vs[gs + s];
      prob[r * ld + s] = bf16_round(p * vsc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], off);
    if (lane == 0) wsum[warp][r] = sum[r];
  }
  __syncthreads();

  // pass 3: weighted sum of the V codes
  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int s0 = warp * kUnroll; s0 < n; s0 += kWarps * kUnroll) {
    int w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u;
      w[u] = 0;
      if (s < n && lane_on) {
        const int8_t* row = (CUR && s == nb) ? vcur + (size_t)g * D : vc + (gs + s) * D;
        w[u] = __ldg(reinterpret_cast<const int*>(row + lane * 4));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u;
      if (s >= n) break;
      float v4[4];
      unpack4(w[u], v4);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pv = prob[r * ld + s];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(pv, v4[c], acc[r][c]);  // exact product
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
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, d = i - (i / D) * D;
    float den = wsum[0][r];
    float o = red[r * kMaxD + d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      den += wsum[w][r];
      o += red[(w * R + r) * kMaxD + d];
    }
    out[((size_t)g * R + r) * D + d] = o / fmaxf(den, 1e-30f);
  }
}

// The wrapper (ops/decode_attention.py::_smem_bytes) checks the same size
// against the card's limit before launching.
size_t smem_bytes(int R, int S) {
  return sizeof(float) * ((size_t)kWarps * R * kMaxD + (size_t)R * (S + 1));
}

template <int R, bool CUR>
cudaError_t launch(const int8_t* kc, const float* ks, const int8_t* vc, const float* vs,
                   const float* q, const int* bound, const int8_t* kcur, const float* kscur,
                   const int8_t* vcur, const float* vscur, float* out, int G, int S, int D,
                   cudaStream_t stream) {
  const size_t bytes = smem_bytes(R, S);
  cudaError_t err = cudaFuncSetAttribute(decode_attend_kernel<R, CUR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  decode_attend_kernel<R, CUR><<<G, kThreads, bytes, stream>>>(
      kc, ks, vc, vs, q, bound, kcur, kscur, vcur, vscur, out, S, D);
  return cudaGetLastError();
}

template <bool CUR>
cudaError_t dispatch(int R, const int8_t* kc, const float* ks, const int8_t* vc,
                     const float* vs, const float* q, const int* bound, const int8_t* kcur,
                     const float* kscur, const int8_t* vcur, const float* vscur, float* out,
                     int G, int S, int D, cudaStream_t st) {
#define MN_CASE(RR) \
  case RR:          \
    return launch<RR, CUR>(kc, ks, vc, vs, q, bound, kcur, kscur, vcur, vscur, out, G, S, D, st);
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

}  // namespace

// Codes (G, S, D) int8, scales (G, S) f32, q (G, R, D) f32, bound (G,) int32,
// out (G, R, D) f32. With has_cur, kcur/vcur (G, D) int8 and kscur/vscur (G,) f32
// are the current rows (ignored otherwise).
extern "C" int mn_decode_attend_q8kv(const void* kc, const void* ks, const void* vc,
                                     const void* vs, const void* q, const void* bound,
                                     const void* kcur, const void* kscur, const void* vcur,
                                     const void* vscur, void* out, int G, int S, int D, int R,
                                     int has_cur, void* stream) {
  if (G <= 0 || S <= 0 || D <= 0 || D > kMaxD || D % 4 || R < 1 || R > 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* kc8 = static_cast<const int8_t*>(kc);
  const int8_t* vc8 = static_cast<const int8_t*>(vc);
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
  const float* qf = static_cast<const float*>(q);
  const int* bd = static_cast<const int*>(bound);
  float* o = static_cast<float*>(out);
  cudaError_t err =
      has_cur ? dispatch<true>(R, kc8, ksf, vc8, vsf, qf, bd, static_cast<const int8_t*>(kcur),
                               static_cast<const float*>(kscur),
                               static_cast<const int8_t*>(vcur),
                               static_cast<const float*>(vscur), o, G, S, D, st)
              : dispatch<false>(R, kc8, ksf, vc8, vsf, qf, bd, nullptr, nullptr, nullptr,
                                nullptr, o, G, S, D, st);
  return (int)err;
}
