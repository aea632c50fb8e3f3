// Paged int8-KV decode attention, for Hopper (sm_90a).
//
// Replaces two TPU kernels of micronet_tpu/ops/paged_attention.py:
//   paged_decode_attend      (Pallas body _paged_kernel)      CUR = false
//   paged_decode_attend_cur  (Pallas body _paged_kernel_cur)  CUR = true
// with the bodies of decode_attention.cuh over PagedRows: each KV group
// (slot, head) reads its positions straight from the page pool through the
// page table, in the regime the dense kernels use at the same S = MP * page
// (one block per group, or split S). Position s of a slot lives in pool page
// table[slot, s / page] at row s % page, so the pool and the dense view
// gathered from it give bit for bit the same result.
//
// What bounds it: bytes, as the dense kernels (decode_attention.cuh), plus one
// 4-byte table read per position, which stays in L1. The TPU kernel's
// workarounds are not copied: no 8-row query padding, no all-heads-per-step
// grid (a per-step overhead of the TPU), and no clamped tail pages: a block
// stops at its slot's length and never reads a page past it, nor the zero page.

#include "decode_attention.cuh"

// Pool codes (P, H, page, D) int8, scales (P, H, 1, page) f32, table (slots, MP)
// int32, lengths (slots,) int32, q (slots, H, R, D) f32, out (slots, H, R, D)
// f32. With has_cur, kcur/vcur (slots, H, D) int8 and kscur/vscur (slots, H)
// f32 are the current rows. With split, scratch holds at least
// mn_attn::split_scratch_floats(slots * H, MP * page, D, R) floats.
extern "C" int mn_paged_decode_attend(const void* kc, const void* ks, const void* vc,
                                      const void* vs, const void* q, const void* table,
                                      const void* lengths, const void* kcur, const void* kscur,
                                      const void* vcur, const void* vscur, void* out,
                                      void* scratch, long long scratch_floats, int slots, int H,
                                      int page, int MP, int D, int R, int has_cur, int split,
                                      void* stream) {
  if (slots <= 0 || H <= 0 || page <= 0 || MP <= 0) return (int)cudaErrorInvalidValue;
  const int G = slots * H, S = MP * page;
  if (!mn_attn::valid_args(G, S, D, R, split, scratch, scratch_floats))
    return (int)cudaErrorInvalidValue;
  const mn_attn::PagedRows rows{static_cast<const int*>(table),
                                static_cast<const int*>(lengths), H, page, MP};
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
