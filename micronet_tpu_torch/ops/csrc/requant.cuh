// The integer engine's epilogue arithmetic for a symmetric conv, in the f32 steps and order of
// ops/requant_epilogue.py::requant_epilogue_ref, shared by the kernels that end such a conv
// (requant_epilogue.cu after a GEMM, dwconv_int8.cu after a depthwise conv), so that every
// route gives the same bits:
//
//   v = f32(acc)                       __int2float_rn (an f32 acc is taken as it is)
//   v = v * (s_x * w_scale[o])         int32 acc only; the scale product is PyTorch's own
//   v = v + bias[o]                    where there is a bias
//   t = v / out_scale                  chained: a true division,
//   q = sign(t) * floor(|t| + 0.5)     round half away,
//   out = int8(clamp(q, qmin, qmax))
//
// Every multiply, add and divide is written __fmul_rn, __fadd_rn or __fdiv_rn: the builds leave
// --fmad on, and a contracted FMA (or a reciprocal multiply) would move codes at .5 edges.

#pragma once

#include <cuda_runtime.h>

namespace mn_requant {

// f32(acc), times the channel's scale s_x * w_scale[o] for an int32 acc; an f32 acc (the
// first layer's f32 GEMM, already scaled) is taken as it is
__device__ __forceinline__ float scaled(int a, float sc) {
  return __fmul_rn(__int2float_rn(a), sc);
}
__device__ __forceinline__ float scaled(float a, float) { return a; }

template <typename In, bool kBias>
__device__ __forceinline__ float value(In a, float sc, float b) {
  const float v = scaled(a, sc);
  return kBias ? __fadd_rn(v, b) : v;
}

// clamp(sign(t) * floor(|t| + 0.5), qmin, qmax) as int8, t = v / out_scale
__device__ __forceinline__ int requant(float v, float s, float qmin, float qmax) {
  const float t = __fdiv_rn(v, s);
  const float r = floorf(__fadd_rn(fabsf(t), 0.5f));
  const float q = t > 0.f ? r : (t < 0.f ? -r : 0.f);
  return __float2int_rz(fminf(fmaxf(q, qmin), qmax));
}

// s_x * w_scale[c], the scale of channel c's int32 accumulator (0 without w_scale: an f32 acc)
__device__ __forceinline__ float channel_scale(float s_x, const float* w_scale, int c) {
  return w_scale == nullptr ? 0.f : __fmul_rn(s_x, __ldg(w_scale + c));
}

}  // namespace mn_requant
