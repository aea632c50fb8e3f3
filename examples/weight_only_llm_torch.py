"""Weight-only int4 compression of a parameter dict with the PyTorch/CUDA
port.

Run:  python examples/weight_only_llm_torch.py [--device cpu]

The port's counterpart of ``examples/weight_only_llm.py``: quantize every
large 2-D weight of a transformer block's parameters to packed int4 with
per-column scales (about 8x smaller), run its matmuls through the W4
kernel (``WOTensor.matmul``: K3 on the card, its plain twin on the CPU),
and check the output against the float block. Runs on the card unless
given ``--device cpu``.
"""

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    from micronet_tpu_torch._device import resolve_device
    from micronet_tpu_torch.quant.weight_only import WOTensor, pytree_bytes, quantize_pytree

    dev = resolve_device(args.device)
    d, dff = 1024, 4096
    rng = np.random.RandomState(0)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    params = {
        "attn_qkv": t(rng.randn(d, 3 * d) * 0.02),
        "attn_out": t(rng.randn(d, d) * 0.02),
        "mlp_up": t(rng.randn(d, dff) * 0.02),
        "mlp_down": t(rng.randn(dff, d) * 0.02),
        "ln_scale": torch.ones((d,), device=dev),  # 1-D: stays float
    }

    def block(p, x):
        def mm(w, x):
            return w.matmul(x) if isinstance(w, WOTensor) else x @ w

        q, k, v = torch.split(mm(p["attn_qkv"], x), d, dim=-1)
        att = torch.softmax(q @ k.T / math.sqrt(d), dim=-1) @ v
        x = x + mm(p["attn_out"], att)
        x = x * p["ln_scale"]
        return x + mm(p["mlp_down"], torch.nn.functional.gelu(mm(p["mlp_up"], x),
                                                              approximate="tanh"))

    x = t(rng.randn(8, d) * 0.5)
    y_fp = block(params, x)
    qparams = quantize_pytree(params, min_size=1 << 14)
    y_q = block(qparams, x)

    ratio = pytree_bytes(params) / pytree_bytes(qparams)
    rel = float((y_q - y_fp).abs().max() / (y_fp.abs().max() + 1e-9))
    print(f"compression: {ratio:.1f}x   max rel err: {rel:.4f}")
    if not (ratio > 6 and rel < 0.1):
        raise SystemExit("weight-only int4 missed its bounds (ratio > 6, rel < 0.1)")


if __name__ == "__main__":
    main()
