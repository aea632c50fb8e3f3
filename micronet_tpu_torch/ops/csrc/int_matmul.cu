// Int8 matmuls with the activation quantize and the dequantize fused, for Hopper (sm_90a).
//
// K1 replaces the TPU kernel micronet_tpu/ops/int_matmul.py::int8_matmul_dequant (Pallas
// body _kernel). It computes what the XLA oracle int8_matmul_dequant_xla computes, for
// x (M, K) f32, w_q (K, N) int8 (row-major), w_scale (N,) f32 and per-tensor s_x, zp:
//
//   q   = clamp(round_half_away(x / s_x) - zp, qmin, qmax)       int8
//   acc = q . w_q + int(zp) * colsum(w_q)                        int32, exact
//   out = f32(acc) * (s_x * w_scale[n])
//
// qmin/qmax are the activation range (narrower than int8 at A4). Every f32 step is the
// oracle's: a true division x / s_x (a reciprocal multiply would move codes that sit on
// a .5 boundary), round half away as floor(|v| + 0.5) with the sign put back, and an
// epilogue of two rounded multiplies (__fmul_rn keeps nvcc from contracting anything
// into an FMA). The bias stays outside the kernel, as in the JAX package. So the kernel
// and its twin agree bit for bit.
//
// What bounds it on an H100: at the engine's call (ResNet-18's fc, M = 512, K = 512,
// N = 10) the bytes, about 1.07 MB or 0.32 us at 3.35 TB/s, so the launch dominates; at a
// large square call (8192, 4096, 4096) the int8 operations, 0.139 ms at 1,979 TOP/s.
// This first version is simple and right rather than fast: each block quantizes a
// 128 x 32 stripe of x into shared memory, stages the matching 32 x 128 tile of w_q
// transposed so four k values pack one 32-bit word, and each of its 256 threads sums an
// 8 x 8 tile of outputs with __dp4a (CUDA cores, int32 accumulators). Ragged M, N and K
// are masked in the kernel: codes and weights outside the matrix are 0. Tensor cores
// (mma.sync / wgmma on s8) and TMA are later work.
//
// K2 replaces micronet_tpu/ops/int_matmul.py::binary_act_matmul (Pallas body
// _sign_kernel): the same kernel instantiated with kBinary, whose quantize is the wbwtab
// sign, q = x >= 0 ? +1 : -1 (0 and -0.0 give +1, NaN gives -1), with no zero point, and
// whose epilogue is f32(acc) * alpha[n], one rounded multiply. w_q holds {-1, 0, +1}.
// The ragged K edge is masked with code 0, never with x = 0, which would binarize to +1.
// At the wbwtab engine's largest 1x1 conv as a GEMM (M = 65,536, K = N = 1,024) the
// bytes bound it: 0.54 GB of f32 x and f32 out, 0.16 ms at 3.35 TB/s, against 137 G
// int8 operations, 0.069 ms at 1,979 TOP/s. __dp4a on the CUDA cores reaches neither
// (tensor cores are later work).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // rows of x per block
constexpr int kBN = 128;  // columns of w per block
constexpr int kBK = 32;   // k values per stage (8 words of 4 int8)
constexpr int kKW = kBK / 4;
constexpr int kThreads = 256;  // 16 x 16, each an 8 x 8 output tile
constexpr int kTM = 8;
constexpr int kTN = 8;

__device__ __forceinline__ int8_t quantize(float x, float s, float zp, float qmin,
                                           float qmax) {
  const float v = __fdiv_rn(x, s);
  float r = floorf(__fadd_rn(fabsf(v), 0.5f));
  r = v < 0.f ? -r : (v > 0.f ? r : 0.f);  // sign(v) * floor(|v| + 0.5)
  const float q = fminf(fmaxf(__fsub_rn(r, zp), qmin), qmax);
  return (int8_t)(int)q;
}

__device__ __forceinline__ int8_t sign_code(float x) { return x >= 0.f ? 1 : -1; }

// kBinary = false: K1 (quantize, zero point, s_x * w_scale); true: K2 (sign, alpha).
template <bool kBinary>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ w_scale, const float* __restrict__ sx_p,
                   const float* __restrict__ zp_p, float* __restrict__ out, int M, int K,
                   int N, float qmin, float qmax) {
  // As: the quantized x stripe, row-major bytes; Bs: w tile transposed, one row of
  // kKW words per column (+1 word of padding against bank conflicts)
  __shared__ __align__(16) int8_t As[kBM][kBK];
  __shared__ int Bs[kBN][kKW + 1];

  const float s_x = kBinary ? 1.f : *sx_p;
  const float zp = kBinary ? 0.f : *zp_p;
  const int izp = (int)zp;  // truncation, as the oracle's astype(int32)
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  int acc[kTM][kTN];
  int cs[kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;
#pragma unroll
  for (int j = 0; j < kTN; ++j) cs[j] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the previous stage is fully read
    // x stripe: 128 x 32 values, a warp reads 32 consecutive k of one row
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const int gm = m0 + r, gk = k0 + c;
      int8_t q = 0;
      if (gm < M && gk < K) {
        const float v = x[(size_t)gm * K + gk];
        q = kBinary ? sign_code(v) : quantize(v, s_x, zp, qmin, qmax);
      }
      As[r][c] = q;
    }
    // w tile: word (n, kw) packs w[k0 + 4kw + 0..3][n0 + n], low byte first
    for (int i = threadIdx.x; i < kBN * kKW; i += kThreads) {
      const int n = i % kBN, kw = i / kBN;
      const int gn = n0 + n;
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int gk = k0 + 4 * kw + b;
        const uint32_t byte = (gn < N && gk < K) ? (uint8_t)w[(size_t)gk * N + gn] : 0u;
        word |= byte << (8 * b);
      }
      Bs[n][kw] = (int)word;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kKW; ++kw) {
      int a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        a[i] = *reinterpret_cast<const int*>(&As[ty + 16 * i][4 * kw]);
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = Bs[tx + 16 * j][kw];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
      if (izp != 0) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) cs[j] = __dp4a(0x01010101, b[j], cs[j]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int gn = n0 + tx + 16 * j;
    if (gn >= N) continue;
    const float scale = kBinary ? w_scale[gn] : __fmul_rn(s_x, w_scale[gn]);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int gm = m0 + ty + 16 * i;
      if (gm < M) {
        const int a = acc[i][j] + izp * cs[j];
        out[(size_t)gm * N + gn] = __fmul_rn(__int2float_rn(a), scale);
      }
    }
  }
}

}  // namespace

// x (M, K) f32, w_q (K, N) int8, w_scale (N,) f32, s_x and zp one f32 each (device
// pointers), out (M, N) f32. Returns cudaGetLastError() after the launch.
extern "C" int mn_int8_matmul_dequant(const void* x, const void* w_q, const void* w_scale,
                                      const void* s_x, const void* zp, void* out, int M,
                                      int K, int N, float qmin, float qmax, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || (M + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_matmul_kernel<false><<<grid, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w_q),
      static_cast<const float*>(w_scale), static_cast<const float*>(s_x),
      static_cast<const float*>(zp), static_cast<float*>(out), M, K, N, qmin, qmax);
  return (int)cudaGetLastError();
}

// K2: x (M, K) f32, w_q (K, N) int8 in {-1, 0, +1}, alpha (N,) f32, out (M, N) f32.
// Returns cudaGetLastError() after the launch.
extern "C" int mn_binary_act_matmul(const void* x, const void* w_q, const void* alpha,
                                    void* out, int M, int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || (M + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_matmul_kernel<true><<<grid, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w_q),
      static_cast<const float*>(alpha), nullptr, nullptr, static_cast<float*>(out), M, K, N,
      0.f, 0.f);
  return (int)cudaGetLastError();
}
