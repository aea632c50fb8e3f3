// Decode attention over a dense int8 K/V cache, for Hopper (sm_90a).
//
// Replaces four TPU kernels of micronet_tpu/ops/decode_attention.py:
//   decode_attend_q8kv              (Pallas body _kernel)             CUR = false
//   decode_attend_q8kv_cur          (Pallas body _kernel_cur)         CUR = true
//   decode_attend_q8kv_blocked      (Pallas body _kernel_blocked)     CUR = false
//   decode_attend_q8kv_blocked_cur  (Pallas body _kernel_blocked_cur) CUR = true
// All four run the bodies of decode_attention.cuh, in the regime the wrapper
// picks from S alone: one cluster of blocks per KV group up to S = 16,384
// (one launch, the logits in shared memory, the products on the tensor
// cores), the split regime past it. What bounds them is bytes: the kernel's
// whole design is to keep the card's memory busy (tens of KB of cp.async in
// flight on every SM, each group spread over a cluster) with its arithmetic
// off that path (decode_attention.cuh). The blocked kernels' online softmax
// is not copied: both regimes keep the oracles' global-max rounding, so they
// agree with the same plain twin, and a blocked and a whole-cache wrapper at
// the same S run the same kernel.

#include "decode_attention.cuh"

// Codes (G, S, D) int8, scales (G, S) f32, q (G, R, D) f32, bound (G,) int32,
// out (G, R, D) f32. With has_cur, kcur/vcur (G, D) int8 and kscur/vscur (G,)
// f32 are the current rows (ignored otherwise). cluster == mn_attn::kCluster
// runs the cluster regime (slices of at most lmax positions); cluster == 0
// the split regime, whose scratch holds at least
// mn_attn::split_scratch_floats(G, S, D, R) floats. Any other cluster size is
// refused.
extern "C" int mn_decode_attend_q8kv(const void* kc, const void* ks, const void* vc,
                                     const void* vs, const void* q, const void* bound,
                                     const void* kcur, const void* kscur, const void* vcur,
                                     const void* vscur, void* out, void* scratch,
                                     long long scratch_floats, int G, int S, int D, int R,
                                     int has_cur, int cluster, int lmax, void* stream) {
  if (!mn_attn::valid_args(G, S, D, R, cluster, lmax, scratch, scratch_floats))
    return (int)cudaErrorInvalidValue;
  const mn_attn::DenseRows rows{static_cast<const int*>(bound), S};
  const mn_attn::Operands op{
      static_cast<const int8_t*>(kc),   static_cast<const float*>(ks),
      static_cast<const int8_t*>(vc),   static_cast<const float*>(vs),
      static_cast<const float*>(q),     static_cast<const int8_t*>(kcur),
      static_cast<const float*>(kscur), static_cast<const int8_t*>(vcur),
      static_cast<const float*>(vscur), static_cast<float*>(out),
      S, D};
  return (int)mn_attn::dispatch(rows, op, G, R, has_cur != 0, cluster, lmax,
                                static_cast<float*>(scratch),
                                reinterpret_cast<cudaStream_t>(stream));
}

// How many clusters of the dense current-row kernel the card holds at once at
// R rows and slices of lmax positions (cluster as above), into *clusters (0:
// the launch would be refused).
extern "C" int mn_decode_attend_cluster_occupancy(int R, int cluster, int lmax, int* clusters) {
  if (!mn_attn::valid_args(1, 1, mn_attn::kMaxD, R, cluster, lmax, nullptr, 0))
    return (int)cudaErrorInvalidValue;
  return (int)mn_attn::cluster_occupancy<mn_attn::DenseRows>(1, R, cluster, lmax, clusters);
}

#ifdef MN_ATTN_TIMELINE
// The diagnostic build's stamps: kStamps a block, for the first kStampBlocks
// blocks of the last launch (tools/attn_variants.py --timeline).
extern "C" int mn_attn_timeline(void* dst, int n) {
  if (n > kStampBlocks * kStamps) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(dst, mn_attn_stamps, sizeof(unsigned long long) * n);
}
#endif
