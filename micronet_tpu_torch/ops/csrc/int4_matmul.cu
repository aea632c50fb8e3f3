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
// over: Hopper unpacks with integer ops, q_hi = b >> 4 (arithmetic shift) and
// q_lo = (b & 0xF) - 8.
//
// What bounds it: at decode (M <= 8) the weight bytes, (K/2)*N + 4*(K/g)*N per call,
// about 4 GB per Llama-3-8B step. The design for that: each thread reads 4 packed
// bytes of one row (one 32-bit load; a warp reads 128 contiguous bytes), loops down
// the K/2 rows of its K-split, and keeps every M row of its tile in registers, so a
// weight byte is read from device memory once per M tile. A K-split across blocks
// (chosen from K and N only) gives the card enough blocks at N = 4096; a second
// small kernel sums the splits in a fixed order. Products bf16(x) * code are exact in
// f32, and each output element is summed in an order that does not depend on M, so
// a row's result does not depend on what shares its batch (the serving loop's
// isolation contract). Arithmetic is f32 FMA on the CUDA cores; at M = 8 that, not
// the bytes, is the limit of this first version (tensor cores are later work).
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
// They share K3's scheme and its bound (the weight bytes at decode): 4 columns a thread,
// each M row of the tile in registers, and a K-split chosen from K, N and the card only, so
// a row's result does not depend on its batch. x is staged in chunks of kChunk packed rows,
// so K/2 need not be a multiple of anything; the scale rows of K9 are reloaded where a
// group starts.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 4;                     // columns per thread: one 32-bit load
constexpr int kBlockN = kThreads * kCols;    // 512 columns per block
constexpr int kMaxGroup = 256;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// grid: x = M tile (fastest, so blocks sharing a weight tile run together and hit
// L2), y = column block, z = K split.
template <int MT>
__global__ void __launch_bounds__(kThreads)
int4_hl8_kernel(const float* __restrict__ x, const int8_t* __restrict__ packed,
                const float* __restrict__ gscale, float* __restrict__ dst,
                int M, int K, int N, int group, int splits) {
  const int k2 = K / 2;
  const int g1 = k2 / group;
  const int m0 = blockIdx.x * MT;
  const int n0 = (blockIdx.y * kThreads + threadIdx.x) * kCols;
  const int split = blockIdx.z;
  const int gi_begin = (int)((long long)g1 * split / splits);
  const int gi_end = (int)((long long)g1 * (split + 1) / splits);
  const bool col_ok = n0 < N;  // the wrapper checks N % 4 == 0

  __shared__ float xs_lo[MT][kMaxGroup];
  __shared__ float xs_hi[MT][kMaxGroup];

  float acc[MT][kCols];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0.f;

  for (int gi = gi_begin; gi < gi_end; ++gi) {
    const int r0 = gi * group;
    __syncthreads();  // previous group's x tile fully read
    for (int i = threadIdx.x; i < MT * group; i += kThreads) {
      const int m = i / group, j = i - (i / group) * group;
      float lo = 0.f, hi = 0.f;
      if (m0 + m < M) {
        const float* xr = x + (size_t)(m0 + m) * K;
        lo = bf16_round(xr[r0 + j]);
        hi = bf16_round(xr[k2 + r0 + j]);
      }
      xs_lo[m][j] = lo;
      xs_hi[m][j] = hi;
    }
    __syncthreads();
    if (!col_ok) continue;  // still joins every __syncthreads above

    float plo[MT][kCols], phi[MT][kCols];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < kCols; ++c) plo[m][c] = phi[m][c] = 0.f;

    const int8_t* wp = packed + (size_t)r0 * N + n0;
#pragma unroll 4
    for (int j = 0; j < group; ++j) {
      const int w = __ldg(reinterpret_cast<const int*>(wp + (size_t)j * N));
      float ql[kCols], qh[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int b = (int)(int8_t)((w >> (8 * c)) & 0xFF);  // signed hl8 byte
        qh[c] = (float)(b >> 4);
        ql[c] = (float)((b & 0xF) - 8);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xl = xs_lo[m][j], xh = xs_hi[m][j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          // exact products (8-bit x 4-bit mantissas): FMA == mul + add here
          plo[m][c] = fmaf(xl, ql[c], plo[m][c]);
          phi[m][c] = fmaf(xh, qh[c], phi[m][c]);
        }
      }
    }
    const float4 slo = __ldg(reinterpret_cast<const float4*>(gscale + (size_t)gi * N + n0));
    const float4 shi = __ldg(reinterpret_cast<const float4*>(gscale + (size_t)(g1 + gi) * N + n0));
    const float sl[kCols] = {slo.x, slo.y, slo.z, slo.w};
    const float sh[kCols] = {shi.x, shi.y, shi.z, shi.w};
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        // rounded mul, then add: the oracle's acc + p_lo * s_lo + p_hi * s_hi order
        acc[m][c] = __fadd_rn(acc[m][c], __fmul_rn(plo[m][c], sl[c]));
        acc[m][c] = __fadd_rn(acc[m][c], __fmul_rn(phi[m][c], sh[c]));
      }
  }
  if (!col_ok) return;
  float* base = dst + (size_t)split * M * N;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m0 + m < M) {
      *reinterpret_cast<float4*>(base + (size_t)(m0 + m) * N + n0) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    }
  }
}

// out[i] = ws[0][i] + ws[1][i] + ... in split order (deterministic), times col_scale[n]
// where one is given (K8's epilogue).
__global__ void splitk_sum_kernel(const float* __restrict__ ws, float* __restrict__ out,
                                  int splits, long long mn, const float* __restrict__ col_scale,
                                  int N) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float s = ws[i];
    for (int k = 1; k < splits; ++k) s = __fadd_rn(s, ws[k * mn + i]);
    out[i] = col_scale == nullptr ? s : __fmul_rn(s, col_scale[i % N]);
  }
}

int splitk_sum(const float* ws, float* out, int splits, int M, int N, const float* col_scale,
               cudaStream_t stream) {
  const long long mn = (long long)M * N;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  splitk_sum_kernel<<<blocks, 256, 0, stream>>>(ws, out, splits, mn, col_scale, N);
  return (int)cudaGetLastError();
}

constexpr int kChunk = 128;  // packed rows of x staged in shared memory per step (K8, K9)

// the low nibble of a byte, sign-extended: (b << 4) >> 4 on the byte
__device__ __forceinline__ int low_nibble(int b) {
  return (int)(int8_t)((b & 0xF) << 4) >> 4;
}

// K8 (kGrouped = false, scale (N,)) and K9 (kGrouped = true, scale (K/group, N)).
// grid: x = M tile, y = column block, z = K split (chunks of kChunk packed rows).
template <int MT, bool kGrouped>
__global__ void __launch_bounds__(kThreads)
int4_plain_kernel(const float* __restrict__ x, const int8_t* __restrict__ packed,
                  const float* __restrict__ scale, float* __restrict__ dst, int M, int K, int N,
                  int group, int splits) {
  const int k2 = K / 2;
  const int chunks = (k2 + kChunk - 1) / kChunk;
  const int g1 = kGrouped ? k2 / group : 0;
  const int m0 = blockIdx.x * MT;
  const int n0 = (blockIdx.y * kThreads + threadIdx.x) * kCols;
  const int split = blockIdx.z;
  const int c_begin = (int)((long long)chunks * split / splits);
  const int c_end = (int)((long long)chunks * (split + 1) / splits);
  const bool col_ok = n0 < N;  // the wrapper checks N % 4 == 0

  __shared__ float xs_lo[MT][kChunk];
  __shared__ float xs_hi[MT][kChunk];

  float alo[MT][kCols], ahi[MT][kCols];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) alo[m][c] = ahi[m][c] = 0.f;
  float sl[kCols] = {0.f, 0.f, 0.f, 0.f}, sh[kCols] = {0.f, 0.f, 0.f, 0.f};
  int next_group_row = 0;  // K9: the first packed row past the loaded scale rows

  for (int ci = c_begin; ci < c_end; ++ci) {
    const int r0 = ci * kChunk;
    const int len = min(kChunk, k2 - r0);
    __syncthreads();  // previous chunk's x tile fully read
    for (int i = threadIdx.x; i < MT * kChunk; i += kThreads) {
      const int m = i / kChunk, j = i % kChunk;
      float lo = 0.f, hi = 0.f;
      if (m0 + m < M && j < len) {
        const float* xr = x + (size_t)(m0 + m) * K;
        lo = bf16_round(xr[r0 + j]);
        hi = bf16_round(xr[k2 + r0 + j]);
      }
      xs_lo[m][j] = lo;
      xs_hi[m][j] = hi;
    }
    __syncthreads();
    if (!col_ok) continue;  // still joins every __syncthreads above

    const int8_t* wp = packed + (size_t)r0 * N + n0;
#pragma unroll 4
    for (int j = 0; j < len; ++j) {
      if (kGrouped && r0 + j >= next_group_row) {  // a group starts (or this split does)
        const int gi = (r0 + j) / group;
        next_group_row = (gi + 1) * group;
        const float4 a = __ldg(reinterpret_cast<const float4*>(scale + (size_t)gi * N + n0));
        const float4 b =
            __ldg(reinterpret_cast<const float4*>(scale + (size_t)(g1 + gi) * N + n0));
        sl[0] = a.x; sl[1] = a.y; sl[2] = a.z; sl[3] = a.w;
        sh[0] = b.x; sh[1] = b.y; sh[2] = b.z; sh[3] = b.w;
      }
      const int w = __ldg(reinterpret_cast<const int*>(wp + (size_t)j * N));
      float ql[kCols], qh[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int b = (int)(int8_t)((w >> (8 * c)) & 0xFF);  // signed packed byte
        ql[c] = (float)low_nibble(b);
        qh[c] = (float)(b >> 4);
        if (kGrouped) {  // dequantize once, rounded to bf16, before the dot
          ql[c] = bf16_round(__fmul_rn(ql[c], sl[c]));
          qh[c] = bf16_round(__fmul_rn(qh[c], sh[c]));
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xl = xs_lo[m][j], xh = xs_hi[m][j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          // exact products: FMA == mul + add here
          alo[m][c] = fmaf(xl, ql[c], alo[m][c]);
          ahi[m][c] = fmaf(xh, qh[c], ahi[m][c]);
        }
      }
    }
  }
  if (!col_ok) return;
  float cs[kCols] = {1.f, 1.f, 1.f, 1.f};
  const bool scale_here = !kGrouped && splits == 1;  // else the split sum applies it
  if (scale_here) {
    const float4 s4 = __ldg(reinterpret_cast<const float4*>(scale + n0));
    cs[0] = s4.x; cs[1] = s4.y; cs[2] = s4.z; cs[3] = s4.w;
  }
  float* base = dst + (size_t)split * M * N;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m0 + m >= M) continue;
    float v[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      v[c] = __fadd_rn(alo[m][c], ahi[m][c]);
      if (scale_here) v[c] = __fmul_rn(v[c], cs[c]);
    }
    *reinterpret_cast<float4*>(base + (size_t)(m0 + m) * N + n0) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <bool kGrouped>
int launch_plain(const void* x, const void* packed, const void* scale, void* out, void* ws,
                 int M, int K, int N, int group, int splits, void* stream) {
  const int chunks = (K / 2 + kChunk - 1) / kChunk;
  if (M <= 0 || K <= 0 || K % 2 || N <= 0 || N % kCols || splits < 1 || splits > chunks ||
      (kGrouped && (group <= 0 || (K / 2) % group)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  float* dst = splits > 1 ? static_cast<float*>(ws) : static_cast<float*>(out);
  const float* xf = static_cast<const float*>(x);
  const int8_t* wp = static_cast<const int8_t*>(packed);
  const float* sc = static_cast<const float*>(scale);
  const int mt = M == 1 ? 1 : M == 2 ? 2 : M <= 4 ? 4 : 8;
  dim3 grid((M + mt - 1) / mt, (N + kBlockN - 1) / kBlockN, splits);
  if (mt == 1)
    int4_plain_kernel<1, kGrouped><<<grid, kThreads, 0, st>>>(xf, wp, sc, dst, M, K, N,
                                                                 group, splits);
  else if (mt == 2)
    int4_plain_kernel<2, kGrouped><<<grid, kThreads, 0, st>>>(xf, wp, sc, dst, M, K, N,
                                                                 group, splits);
  else if (mt == 4)
    int4_plain_kernel<4, kGrouped><<<grid, kThreads, 0, st>>>(xf, wp, sc, dst, M, K, N,
                                                                 group, splits);
  else
    int4_plain_kernel<8, kGrouped><<<grid, kThreads, 0, st>>>(xf, wp, sc, dst, M, K, N,
                                                                 group, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return splitk_sum(static_cast<const float*>(ws), static_cast<float*>(out), splits, M, N,
                    kGrouped ? nullptr : sc, st);
}

template <int MT>
void launch(const float* x, const int8_t* packed, const float* gscale, float* dst,
            int M, int K, int N, int group, int splits, cudaStream_t stream) {
  dim3 grid((M + MT - 1) / MT, (N + kBlockN - 1) / kBlockN, splits);
  int4_hl8_kernel<MT><<<grid, kThreads, 0, stream>>>(x, packed, gscale, dst, M, K, N,
                                                      group, splits);
}

}  // namespace

// x (M, K) f32, packed (K/2, N) int8 hl8, gscale (K/group, N) f32, out (M, N) f32.
// With splits > 1, ws is a (splits, M, N) f32 scratch; with splits == 1 it is unused.
extern "C" int mn_int4_matmul_grouped_hl8(const void* x, const void* packed,
                                          const void* gscale, void* out, void* ws,
                                          int M, int K, int N, int group, int splits,
                                          void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || N % kCols || group <= 0 || group > kMaxGroup ||
      (K / 2) % group || splits < 1 || splits > (K / 2) / group)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  float* dst = splits > 1 ? static_cast<float*>(ws) : static_cast<float*>(out);
  const float* xf = static_cast<const float*>(x);
  const int8_t* wp = static_cast<const int8_t*>(packed);
  const float* gs = static_cast<const float*>(gscale);
  if (M == 1) launch<1>(xf, wp, gs, dst, M, K, N, group, splits, st);
  else if (M == 2) launch<2>(xf, wp, gs, dst, M, K, N, group, splits, st);
  else if (M <= 4) launch<4>(xf, wp, gs, dst, M, K, N, group, splits, st);
  else launch<8>(xf, wp, gs, dst, M, K, N, group, splits, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return splitk_sum(static_cast<const float*>(ws), static_cast<float*>(out), splits, M, N,
                    nullptr, st);
}

// K8: x (M, K) f32, packed (K/2, N) int8 (pack_int4), scale (N,) f32, out (M, N) f32.
// With splits > 1, ws is a (splits, M, N) f32 scratch; with splits == 1 it is unused.
extern "C" int mn_int4_matmul(const void* x, const void* packed, const void* scale, void* out,
                              void* ws, int M, int K, int N, int splits, void* stream) {
  return launch_plain<false>(x, packed, scale, out, ws, M, K, N, 0, splits, stream);
}

// K9: as K8 with gscale (K/group, N) f32; group must divide K/2.
extern "C" int mn_int4_matmul_grouped(const void* x, const void* packed, const void* gscale,
                                      void* out, void* ws, int M, int K, int N, int group,
                                      int splits, void* stream) {
  return launch_plain<true>(x, packed, gscale, out, ws, M, K, N, group, splits, stream);
}
