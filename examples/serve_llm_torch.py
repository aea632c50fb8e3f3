"""LLM serving with the PyTorch/CUDA port: W4 group-scaled weights, an int8
KV cache and continuous batching, on the card.

Run:  python examples/serve_llm_torch.py [--device cpu]

The port's counterpart of ``examples/serve_llm.py``, at its
configuration: the float TinyDecoder and its ``quantize_decoder(group=32)``
form from one generator (every block linear on the W4 kernel K3, decode
attention on the int8-KV kernel K5a), greedy continuations and the logits'
cosine, a batched prefill, then continuous batching where a late request
takes the first slot that frees up and every request gets its isolated
``generate``'s tokens. Then a tiny Llama behind the paged loop (a shared
page pool, pages back on eviction, chunked prefill) against the dense
loop. On the card the wrappers launch the hand-written kernels; with
``--device cpu`` they run their plain PyTorch twins.
"""

import argparse
import copy
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    from micronet_tpu_torch._device import resolve_device
    from micronet_tpu_torch.models.tiny_decoder import TinyDecoder, quantize_decoder
    from micronet_tpu_torch.quant.kv_cache import kv_cache_bytes
    from micronet_tpu_torch.serve import Request, ServeLoop

    dev = resolve_device(args.device)
    kw = dict(vocab=256, dim=128, heads=8, depth=4, mlp_dim=256, max_seq=64)
    float_model = TinyDecoder(**kw, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(0))
    served = quantize_decoder(copy.deepcopy(float_model), group=32)

    prompt = torch.tensor([12, 99, 7, 45], device=dev)
    print("float  continuation:", float_model.generate(prompt, 8).tolist())
    print("W4+KV8 continuation:", served.generate(prompt, 8).tolist())
    lf, _ = float_model.forward(prompt, float_model.init_cache(), 0)
    lq, _ = served.forward(prompt, served.init_cache(), 0)
    cos = float((lf * lq).sum() / (lf.norm() * lq.norm()))
    print(f"logit cosine vs float: {cos:.4f}")

    # a batched serving step (each slot at its own position)
    toks = torch.tensor([[1, 2, 3], [7, 8, 9]], device=dev)
    logits, _ = served.forward_batch(toks, served.init_cache_batch(2),
                                     torch.zeros((2,), dtype=torch.int32, device=dev))
    print(f"batched prefill logits {tuple(logits.shape)}; int8 KV bytes/layer/request "
          f"{kv_cache_bytes(served.init_cache()[0])}")

    # continuous batching: requests of different lengths share 2 slots; a third
    # arrives mid-flight and takes the first slot that frees up
    loop = ServeLoop(served, max_slots=2, device=dev)
    loop.submit(Request(rid=0, prompt=[12, 99, 7, 45], max_new_tokens=8))
    loop.submit(Request(rid=1, prompt=[3, 5], max_new_tokens=4))
    loop.step()
    loop.submit(Request(rid=2, prompt=[200, 17, 6], max_new_tokens=5))
    done = loop.run()
    for rid in sorted(done):
        r = done[rid]
        iso = served.generate(torch.tensor(r.prompt, device=dev), r.max_new_tokens).tolist()
        tag = "== isolated" if r.output == iso else "!= isolated"
        print(f"request {rid} (len {len(r.prompt)}): {r.output} {tag}")

    # paged serving: the same loop over a shared page pool (a Llama; the
    # TinyDecoder has dense slots only)
    from micronet_tpu_torch.models.llama import Llama, llama_tiny, quantize_llama
    from micronet_tpu_torch.quant.paged_kv import paged_hbm_bytes

    lm = quantize_llama(Llama(llama_tiny(max_seq=32), device=dev), group=16)
    paged = ServeLoop(lm, max_slots=4, paged=True, page_size=8, num_pages=9, prefill_chunk=4,
                      device=dev)
    dense = ServeLoop(lm, max_slots=4, device=dev)
    for loop in (paged, dense):
        loop.submit(Request(rid=0, prompt=[3, 14, 15], max_new_tokens=5))
        loop.submit(Request(rid=1, prompt=[9, 26, 5, 35, 8], max_new_tokens=4))
        loop.run()
    dense_bytes = sum(kv_cache_bytes(c) for c in dense.caches)
    pool_bytes = sum(paged_hbm_bytes(c) for c in paged.caches)
    same = all(paged.finished[r].output == dense.finished[r].output for r in (0, 1))
    print(f"paged ServeLoop: tokens == dense: {same}; KV bytes {pool_bytes} (pool) vs "
          f"{dense_bytes} (dense slots)")


if __name__ == "__main__":
    main()
