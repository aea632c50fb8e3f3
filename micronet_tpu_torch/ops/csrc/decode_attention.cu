// Decode attention over a dense int8 K/V cache, for Hopper (sm_90a).
//
// Replaces four TPU kernels of micronet_tpu/ops/decode_attention.py:
//   decode_attend_q8kv              (Pallas body _kernel)             one block, CUR = false
//   decode_attend_q8kv_cur          (Pallas body _kernel_cur)         one block, CUR = true
//   decode_attend_q8kv_blocked      (Pallas body _kernel_blocked)     split S,   CUR = false
//   decode_attend_q8kv_blocked_cur  (Pallas body _kernel_blocked_cur) split S,   CUR = true
// The bodies, what they compute, what bounds them and what their design does
// about it are in decode_attention.cuh. The blocked kernels' online softmax is
// not copied: the split regime keeps the oracles' global-max rounding, so both
// regimes agree with the same plain twin.

#include "decode_attention.cuh"

// Codes (G, S, D) int8, scales (G, S) f32, q (G, R, D) f32, bound (G,) int32,
// out (G, R, D) f32. With has_cur, kcur/vcur (G, D) int8 and kscur/vscur (G,)
// f32 are the current rows (ignored otherwise). With split, scratch holds at
// least mn_attn::split_scratch_floats(G, S, D, R) floats.
extern "C" int mn_decode_attend_q8kv(const void* kc, const void* ks, const void* vc,
                                     const void* vs, const void* q, const void* bound,
                                     const void* kcur, const void* kscur, const void* vcur,
                                     const void* vscur, void* out, void* scratch,
                                     long long scratch_floats, int G, int S, int D, int R,
                                     int has_cur, int split, void* stream) {
  if (!mn_attn::valid_args(G, S, D, R, split, scratch, scratch_floats))
    return (int)cudaErrorInvalidValue;
  const mn_attn::DenseRows rows{static_cast<const int*>(bound), S};
  const mn_attn::Operands op{
      static_cast<const int8_t*>(kc),   static_cast<const float*>(ks),
      static_cast<const int8_t*>(vc),   static_cast<const float*>(vs),
      static_cast<const float*>(q),     static_cast<const int8_t*>(kcur),
      static_cast<const float*>(kscur), static_cast<const int8_t*>(vcur),
      static_cast<const float*>(vscur), static_cast<float*>(out),
      S, D};
  return (int)mn_attn::dispatch(rows, op, G, R, has_cur != 0, split != 0,
                                static_cast<float*>(scratch),
                                reinterpret_cast<cudaStream_t>(stream));
}
