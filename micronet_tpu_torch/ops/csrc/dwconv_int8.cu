// The integer engine's 3 x 3 depthwise conv in one pass (sm_90a): int8 codes in, the layer's
// output out.
//
// It replaces no TPU kernel. The JAX package runs a grouped IntConv2d as one dense GEMM over a
// block-diagonal weight, and so does the port's block-diagonal route (infer/engine.py): with
// groups = channels that is C times the work and a patch matrix 9 C wide. This kernel computes
// a symmetric depthwise conv (groups = C_in = C_out, 3 x 3, dilation 1) directly, for
//
//   x    (N, H, W, C) int8 codes, contiguous (an NHWC-strided NCHW view in the engine);
//   w    (C, 3, 4) int8: channel c's kernel row kh as its three taps and a zero byte;
//   acc  the exact int32 sum over the 3 x 3 window of channel c, zero codes outside the input
//        (the padding), at stride (sh, sw) and padding (ph, pw);
//
// and ends it with the requant epilogue's arithmetic (csrc/requant.cuh, the requant_epilogue
// kernel's device functions): f32(acc) * (s_x * w_scale[c]), + bias[c], then int8 codes at
// out_scale clamped to [qmin, qmax] (chained) or f32, into out (N, Ho, Wo, C). Its bits
// are the block-diagonal route's (an int32 GEMM, then the requant_epilogue kernel) and the CPU
// twin's (ops/dwconv.py::dwconv_int8_ref).
//
// A depthwise layer moves few bytes for its work (about 9 multiply-adds a byte): each code is
// read once and each output written once, with no tensor cores, TMA or shared memory.
// - vector kernel (C % 4 == 0, 4-byte aligned codes, sh = sw in {1, 2}, fewer than 2^31
//   columns): a thread owns 4 channels of one output column (n, :, wo) and walks down its Ho
//   rows with a window of the three input rows it needs. An input row's three taps arrive as
//   three 4-byte loads (4 channels each, zero outside the input), and 8 byte permutes
//   transpose them into one word a channel (taps kw = 0, 1, 2 and a zero byte), so that one
//   __dp4a with the weight word of kernel row kh adds the row's three products. A step down
//   reads sh new rows, loaded while the step before makes its outputs. Threads lie along the
//   channels, then along wo: a warp's loads and stores are contiguous bytes;
// - scalar kernel (any other shape): one output element a thread, grid-stride.

#include <cuda_runtime.h>
#include <stdint.h>

#include "requant.cuh"

namespace {

using mn_requant::channel_scale;
using mn_requant::requant;
using mn_requant::value;

constexpr int kThreads = 256;

struct Params {
  const int8_t* x;  // (N, H, W, C) contiguous
  const int8_t* w;  // (C, 3, 4)
  const float* s_x;
  const float* w_scale;  // (C,)
  const float* bias;     // (C,) or null
  const float* out_scale;
  void* out;  // (N, Ho, Wo, C) contiguous: int8 chained, else f32
  int n, h, w_in, c, ho, wo, sh, sw, ph, pw;
  float qmin, qmax;
};

// one input row's three words at taps kw = 0, 1, 2 (4 channels each, from channel c); zeros
// outside the input
__device__ __forceinline__ void load_row(const Params& p, int n, int hi, int wi0, int c,
                                         int a[3]) {
  a[0] = a[1] = a[2] = 0;
  if (hi < 0 || hi >= p.h) return;
  const int8_t* row = p.x + ((long long)n * p.h + hi) * p.w_in * p.c + c;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int wi = wi0 + k;
    if (wi >= 0 && wi < p.w_in) a[k] = __ldg(reinterpret_cast<const int*>(row + wi * p.c));
  }
}

// the three words as one word a channel: t[j] = (tap 0, tap 1, tap 2, 0) of channel c + j
__device__ __forceinline__ void transpose_row(const int a[3], int t[4]) {
  const int lo01 = __byte_perm(a[0], a[1], 0x5140);  // a0.b0 a1.b0 a0.b1 a1.b1
  const int hi01 = __byte_perm(a[0], a[1], 0x7362);  // a0.b2 a1.b2 a0.b3 a1.b3
  const int lo2 = __byte_perm(a[2], 0, 0x5140);      // a2.b0 0 a2.b1 0
  const int hi2 = __byte_perm(a[2], 0, 0x7362);      // a2.b2 0 a2.b3 0
  t[0] = __byte_perm(lo01, lo2, 0x5410);
  t[1] = __byte_perm(lo01, lo2, 0x7632);
  t[2] = __byte_perm(hi01, hi2, 0x5410);
  t[3] = __byte_perm(hi01, hi2, 0x7632);
}

template <int kS, bool kBias, bool kChained>
__global__ void __launch_bounds__(kThreads) dwconv_int8_kernel(Params p) {
  // one thread a (n, wo, 4 channels) column; fewer than 2^31 of them (the wrapper's rule), so
  // the divisions are 32-bit ones
  const int quads = p.c / 4;
  const int unit = blockIdx.x * kThreads + threadIdx.x;
  if (unit >= p.n * p.wo * quads) return;
  const int c = unit % quads * 4;
  const int col = unit / quads;
  const int ow = col % p.wo;
  const int n = col / p.wo;
  const float s_x = *p.s_x;
  const float s_out = kChained ? *p.out_scale : 1.f;
  int wt[4][3];
  float sc[4], b[4];
  const int* w = reinterpret_cast<const int*>(p.w) + (long long)c * 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) wt[j][kh] = __ldg(w + j * 3 + kh);
    sc[j] = channel_scale(s_x, p.w_scale, c + j);
    b[j] = kBias ? __ldg(p.bias + c + j) : 0.f;
  }
  const int wi0 = ow * kS - p.pw;
  int hi = -p.ph;  // the window's first input row
  int r0[4], r1[4], r2[4], raw[kS][3];
  load_row(p, n, hi, wi0, c, raw[0]);
  transpose_row(raw[0], r0);
  load_row(p, n, hi + 1, wi0, c, raw[0]);
  transpose_row(raw[0], r1);
  load_row(p, n, hi + 2, wi0, c, raw[0]);
  transpose_row(raw[0], r2);
  for (int oh = 0; oh < p.ho; ++oh) {
    // the next step's kS new rows load while this one's outputs are made
    const bool more = oh + 1 < p.ho;
    if (more) {
#pragma unroll
      for (int k = 0; k < kS; ++k) load_row(p, n, hi + 3 + k, wi0, c, raw[k]);
    }
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int acc =
          __dp4a(r2[j], wt[j][2], __dp4a(r1[j], wt[j][1], __dp4a(r0[j], wt[j][0], 0)));
      v[j] = value<int, kBias>(acc, sc[j], b[j]);
    }
    const long long o = (((long long)n * p.ho + oh) * p.wo + ow) * p.c + c;
    if (kChained) {
      const uint32_t q = (uint32_t)(requant(v[0], s_out, p.qmin, p.qmax) & 0xff) |
                         (uint32_t)(requant(v[1], s_out, p.qmin, p.qmax) & 0xff) << 8 |
                         (uint32_t)(requant(v[2], s_out, p.qmin, p.qmax) & 0xff) << 16 |
                         (uint32_t)(requant(v[3], s_out, p.qmin, p.qmax) & 0xff) << 24;
      *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(p.out) + o) = q;
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(p.out) + o) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    if (!more) break;
    hi += kS;
    if (kS == 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        r0[j] = r1[j];
        r1[j] = r2[j];
      }
      transpose_row(raw[0], r2);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) r0[j] = r2[j];
      transpose_row(raw[0], r1);
      transpose_row(raw[kS - 1], r2);
    }
  }
}

template <bool kBias, bool kChained>
__global__ void __launch_bounds__(kThreads) dwconv_int8_scalar_kernel(Params p) {
  const long long total = (long long)p.n * p.ho * p.wo * p.c;
  const float s_x = *p.s_x;
  const float s_out = kChained ? *p.out_scale : 1.f;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (long long)gridDim.x * kThreads) {
    const int c = (int)(i % p.c);
    const long long pix = i / p.c;
    const int ow = (int)(pix % p.wo);
    const int oh = (int)(pix / p.wo % p.ho);
    const int n = (int)(pix / p.wo / p.ho);
    int acc = 0;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const int hi = oh * p.sh - p.ph + kh;
      if (hi < 0 || hi >= p.h) continue;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int wi = ow * p.sw - p.pw + kw;
        if (wi < 0 || wi >= p.w_in) continue;
        const int xv = __ldg(p.x + (((long long)n * p.h + hi) * p.w_in + wi) * p.c + c);
        acc += xv * (int)__ldg(p.w + c * 12 + kh * 4 + kw);
      }
    }
    const float v = value<int, kBias>(acc, channel_scale(s_x, p.w_scale, c),
                                      kBias ? __ldg(p.bias + c) : 0.f);
    if (kChained) {
      static_cast<int8_t*>(p.out)[i] = (int8_t)requant(v, s_out, p.qmin, p.qmax);
    } else {
      static_cast<float*>(p.out)[i] = v;
    }
  }
}

template <bool kBias, bool kChained>
void launch(const Params& p, bool vector, int blocks, cudaStream_t s) {
  if (!vector) {
    dwconv_int8_scalar_kernel<kBias, kChained><<<blocks, kThreads, 0, s>>>(p);
  } else if (p.sh == 1) {
    dwconv_int8_kernel<1, kBias, kChained><<<blocks, kThreads, 0, s>>>(p);
  } else {
    dwconv_int8_kernel<2, kBias, kChained><<<blocks, kThreads, 0, s>>>(p);
  }
}

}  // namespace

// x (N, H, W, C) int8 contiguous, w (C, 3, 4) int8 contiguous, s_x and out_scale 0-dim f32,
// w_scale (C,) f32, bias (C,) f32 or null; out (N, Ho, Wo, C) contiguous, int8 when chained
// (clamped to [qmin, qmax]) else f32. `vector` picks the vector kernel (C % 4 == 0, x and w
// 4-byte and out 16-byte aligned, sh == sw in {1, 2}: the wrapper checks), whose grid is one
// thread a (n, wo, 4 channels) column; `blocks` is the grid. One launch.
extern "C" int mn_dwconv_int8(const void* x, const void* w, const void* s_x, const void* w_scale,
                              const void* bias, const void* out_scale, void* out, int n, int h,
                              int w_in, int c, int ho, int wo, int sh, int sw, int ph, int pw,
                              int chained, float qmin, float qmax, int vector, int blocks,
                              void* stream) {
  const Params p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
                 static_cast<const float*>(s_x), static_cast<const float*>(w_scale),
                 static_cast<const float*>(bias), static_cast<const float*>(out_scale), out, n, h,
                 w_in, c, ho, wo, sh, sw, ph, pw, qmin, qmax};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v = vector != 0;
  if (bias != nullptr && chained) launch<true, true>(p, v, blocks, s);
  if (bias != nullptr && !chained) launch<true, false>(p, v, blocks, s);
  if (bias == nullptr && chained) launch<false, true>(p, v, blocks, s);
  if (bias == nullptr && !chained) launch<false, false>(p, v, blocks, s);
  return (int)cudaGetLastError();
}
