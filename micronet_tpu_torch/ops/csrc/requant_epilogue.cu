// The integer engine's conv epilogue in one pass (sm_90a): the symmetric IntConv2d's
// accumulator rows in, the layer's output out.
//
// It replaces no TPU kernel. The JAX package's IntConv2d._epilogue
// (micronet_tpu/infer/engine.py) is an XLA elementwise chain that XLA fuses into one pass;
// PyTorch runs the same chain as about twelve kernels (a cast, the scale, the bias, the
// division, round half away's sign, abs, add, floor and product, the clamp, the cast to int8),
// each reading and writing f32 over every output. This kernel is that chain fused, with the
// twin's f32 steps in the twin's order (ops/requant_epilogue.py::requant_epilogue_ref), for
// acc (M, O) with row stride ld elements (a view of the GEMM's padded output), per-channel
// w_scale[o] and bias[o], and 0-dim s_x and out_scale on the card:
//
//   v = f32(acc)                       __int2float_rn (an f32 acc is taken as it is)
//   v = v * (s_x * w_scale[o])         int32 acc only; the scale product is PyTorch's own
//   v = v + bias[o]                    where there is a bias
//   out = v                            unchained: f32 (M, O)
//   t = v / out_scale                  chained: a true division,
//   q = sign(t) * floor(|t| + 0.5)     round half away,
//   out = int8(clamp(q, qmin, qmax))   int8 (M, O)
//
// Every multiply, add and divide is written __fmul_rn, __fadd_rn or __fdiv_rn (csrc/requant.cuh,
// shared with the depthwise kernel), so the kernel gives the twin's bits. The three variants
// (int32 or f32 in, with or without bias, int8 or f32 out) are template flags of one body.
//
// Bytes bound it: 4 bytes in and 1 (or 4) out an element, no reuse (NIN-GC W4A4 at batch 1,024
// moves 6.7 GB a forward: 2.0 ms at 3.35 TB/s). So no tensor cores, TMA or shared memory:
// - vector kernel (O % 4 == 0, 16-byte aligned rows): a thread owns 4 channels of a row and
//   moves them as one 16-byte load and one 4-byte (int8) or 16-byte (f32) store, so a warp
//   reads 512 and writes 128 contiguous bytes. Threads lie along the channels: the grid's
//   thread count is a multiple of O / 4 (the wrapper's grid), so a thread keeps its 4 channels
//   for its whole walk down the rows and holds their scale and bias in registers. A
//   persistent grid of a few blocks an SM walks rows in steps of kUnroll, whose loads are all
//   issued before any is used;
// - scalar kernel (any other shape: the last NIN-GC conv's (M, 10) slice of a 16-wide GEMM, a
//   channel shard): one element a thread, grid-stride.

#include <cuda_runtime.h>
#include <stdint.h>

#include "requant.cuh"

namespace {

using mn_requant::channel_scale;
using mn_requant::requant;
using mn_requant::value;

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

struct Params {
  const void* acc;
  long long ld;  // acc's row stride, in elements
  const float* s_x;
  const float* w_scale;  // (O,), int32 acc only
  const float* bias;     // (O,) or null
  const float* out_scale;
  void* out;  // (M, O) contiguous: int8 chained, else f32
  long long m;
  int o;
  float qmin, qmax;
};

template <typename In>
struct Vec4;
template <>
struct Vec4<int> {
  using T = int4;
};
template <>
struct Vec4<float> {
  using T = float4;
};

template <typename In, bool kBias, bool kChained>
__global__ void __launch_bounds__(kThreads) requant_epilogue_kernel(Params p) {
  using V = typename Vec4<In>::T;
  const long long quads = p.o / 4;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  // the grid's threads are a multiple of quads: each thread keeps channels c..c+3, and a
  // step of the whole grid moves every thread down by `rows` rows
  const long long rows = (long long)gridDim.x * kThreads / quads;
  const int c = (int)(first % quads) * 4;
  const float s_x = *p.s_x;
  const float s_out = kChained ? *p.out_scale : 1.f;
  float sc[4], b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sc[j] = channel_scale(s_x, p.w_scale, c + j);
    b[j] = kBias ? __ldg(p.bias + c + j) : 0.f;
  }
  const In* acc = static_cast<const In*>(p.acc);
  for (long long r = first / quads; r < p.m; r += rows * kUnroll) {
    V a[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long rk = r + k * rows;
      if (rk < p.m) a[k] = __ldg(reinterpret_cast<const V*>(acc + rk * p.ld + c));
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long rk = r + k * rows;
      if (rk >= p.m) break;
      const float v0 = value<In, kBias>(a[k].x, sc[0], b[0]);
      const float v1 = value<In, kBias>(a[k].y, sc[1], b[1]);
      const float v2 = value<In, kBias>(a[k].z, sc[2], b[2]);
      const float v3 = value<In, kBias>(a[k].w, sc[3], b[3]);
      if (kChained) {
        const uint32_t q = (uint32_t)(requant(v0, s_out, p.qmin, p.qmax) & 0xff) |
                           (uint32_t)(requant(v1, s_out, p.qmin, p.qmax) & 0xff) << 8 |
                           (uint32_t)(requant(v2, s_out, p.qmin, p.qmax) & 0xff) << 16 |
                           (uint32_t)(requant(v3, s_out, p.qmin, p.qmax) & 0xff) << 24;
        *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(p.out) + rk * p.o + c) = q;
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(p.out) + rk * p.o + c) =
            make_float4(v0, v1, v2, v3);
      }
    }
  }
}

template <typename In, bool kBias, bool kChained>
__global__ void __launch_bounds__(kThreads) requant_epilogue_scalar_kernel(Params p) {
  const long long n = p.m * p.o;
  const float s_x = *p.s_x;
  const float s_out = kChained ? *p.out_scale : 1.f;
  const In* acc = static_cast<const In*>(p.acc);
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const long long r = i / p.o;
    const int c = (int)(i - r * p.o);
    const float v = value<In, kBias>(__ldg(acc + r * p.ld + c), channel_scale(s_x, p.w_scale, c),
                                     kBias ? __ldg(p.bias + c) : 0.f);
    if (kChained) {
      static_cast<int8_t*>(p.out)[i] = (int8_t)requant(v, s_out, p.qmin, p.qmax);
    } else {
      static_cast<float*>(p.out)[i] = v;
    }
  }
}

template <typename In, bool kBias, bool kChained>
void launch(const Params& p, bool vector, int blocks, cudaStream_t s) {
  if (vector) {
    requant_epilogue_kernel<In, kBias, kChained><<<blocks, kThreads, 0, s>>>(p);
  } else {
    requant_epilogue_scalar_kernel<In, kBias, kChained><<<blocks, kThreads, 0, s>>>(p);
  }
}

template <typename In>
void launch_in(const Params& p, bool chained, bool vector, int blocks, cudaStream_t s) {
  const bool bias = p.bias != nullptr;
  if (bias && chained) launch<In, true, true>(p, vector, blocks, s);
  if (bias && !chained) launch<In, true, false>(p, vector, blocks, s);
  if (!bias && chained) launch<In, false, true>(p, vector, blocks, s);
  if (!bias && !chained) launch<In, false, false>(p, vector, blocks, s);
}

}  // namespace

// acc (M, O) int32 (acc_int 1, with w_scale) or f32 (acc_int 0, w_scale null), its rows ld
// elements apart; s_x, out_scale 0-dim f32; w_scale, bias (O,) f32 or null; out (M, O)
// contiguous, int8 when chained (then clamped to [qmin, qmax]) else f32. `vector` picks the
// vector kernel (O % 4 == 0, ld % 4 == 0, acc and out 16-byte aligned: the wrapper checks) and
// `blocks` is the grid (for the vector kernel a multiple of (O / 4) / gcd(O / 4, 256) blocks,
// so that its threads are a multiple of O / 4). One launch.
extern "C" int mn_requant_epilogue(const void* acc, int acc_int, long long ld, const void* s_x,
                                   const void* w_scale, const void* bias, const void* out_scale,
                                   void* out, long long M, int O, int chained, float qmin,
                                   float qmax, int vector, int blocks, void* stream) {
  const Params p{acc, ld, static_cast<const float*>(s_x), static_cast<const float*>(w_scale),
                 static_cast<const float*>(bias), static_cast<const float*>(out_scale), out, M,
                 O, qmin, qmax};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (acc_int) {
    launch_in<int>(p, chained != 0, vector != 0, blocks, s);
  } else {
    launch_in<float>(p, chained != 0, vector != 0, blocks, s);
  }
  return (int)cudaGetLastError();
}
