"""Ship-with-the-package smoke tests: the counterpart of
``micronet_tpu/selftest.py``.

``quant_test_manual`` builds LeNet-style nets with hand-placed quant
layers of all three flavours and runs a forward; ``quant_test_auto`` runs
``prepare()`` on the stock LeNet for every method, KL PTQ included, then
a two-token forward of a W4 (group 8) ``TinyDecoder`` over its int8 KV
cache. Both print "micronet_tpu_torch is ready" on success, on ``device``
(None = CUDA, which raises without a card).

Run: ``python -c "import micronet_tpu_torch as m; m.quant_test_manual('cpu')"``
"""

from __future__ import annotations

import torch
from torch import nn

from ._device import resolve_device

__all__ = ["quant_test_manual", "quant_test_auto"]


def _input(dev, batch: int = 2) -> torch.Tensor:
    return torch.ones((batch, 32, 32, 3), device=dev)


def quant_test_manual(device=None) -> None:
    """Hand-assembled quant LeNets, one per flavour."""
    from .nn import modules as M
    from .nn import qat_dorefa, qat_iao, qat_wbwtab
    from .quant.config import QuantConfig

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    kw = dict(device=dev, generator=gen)
    cfg = QuantConfig(a_bits=8, w_bits=8)
    wcfg = QuantConfig(W=2, A=2)
    flatten = M.Flatten()

    class IaoLeNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.c1 = qat_iao.QuantConv2d(3, 6, 5, cfg=cfg, **kw)
            self.p1 = qat_iao.QuantMaxPool2d(2, 2, cfg=cfg, device=dev)
            self.c2 = qat_iao.QuantConv2d(6, 16, 5, cfg=cfg, **kw)
            self.p2 = qat_iao.QuantAdaptiveAvgPool2d((5, 5), cfg=cfg, device=dev)
            self.fc = qat_iao.QuantLinear(16 * 5 * 5, 10, cfg=cfg, **kw)

        def forward(self, x):
            x = self.p1(torch.relu(self.c1(x.permute(0, 3, 1, 2))))
            x = self.p2(torch.relu(self.c2(x)))
            return self.fc(flatten(x))

    class DorefaLeNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.c1 = qat_dorefa.QuantConv2d(3, 6, 5, cfg=cfg, **kw)
            self.c2 = qat_dorefa.QuantConv2d(6, 16, 5, cfg=cfg, **kw)
            self.fc = qat_dorefa.QuantLinear(16 * 24 * 24, 10, cfg=cfg, **kw)

        def forward(self, x):
            x = torch.relu(self.c1(x.permute(0, 3, 1, 2)))
            return self.fc(flatten(torch.relu(self.c2(x))))

    class WbwtabLeNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.c1 = qat_wbwtab.QuantConv2d(3, 6, 5, cfg=wcfg, **kw)
            self.a1 = qat_wbwtab.ActivationQuantizer(A=2)
            self.c2 = qat_wbwtab.QuantConv2d(6, 16, 5, cfg=wcfg, **kw)
            self.fc = M.Linear(16 * 24 * 24, 10, **kw)

        def forward(self, x):
            x = self.a1(self.c1(x.permute(0, 3, 1, 2)))
            return self.fc(flatten(self.c2(x)))

    for name, net in (("iao", IaoLeNet()), ("dorefa", DorefaLeNet()),
                      ("wbwtab", WbwtabLeNet())):
        with torch.no_grad():
            out = net(_input(dev))
        assert out.shape == (2, 10), (name, out.shape)
    print("micronet_tpu_torch is ready")


def quant_test_auto(device=None) -> None:
    """``prepare()`` on the stock LeNet for every flavour, KL PTQ included;
    then the serving kit: a W4 (group 8) decoder over its int8 KV cache."""
    from .models.lenet import LeNet
    from .models.tiny_decoder import TinyDecoder, quantize_decoder
    from .nn import prepare
    from .quant.config import QuantConfig

    dev = resolve_device(device)
    for method, cfg in (
        ("iao", QuantConfig(a_bits=8, w_bits=8)),
        ("iao", QuantConfig(a_bits=8, w_bits=8, bn_fuse=True)),
        ("dorefa", QuantConfig(a_bits=8, w_bits=8)),
        ("wbwtab", QuantConfig(W=2, A=2)),
        ("iao", QuantConfig(a_bits=8, w_bits=8, ptq=True, ptq_observer="kl")),
    ):
        gen = torch.Generator(device=dev).manual_seed(0)
        q = prepare(LeNet(device=dev, generator=gen), cfg, method=method, device=dev)
        with torch.no_grad():
            out = q(_input(dev))
        assert out.shape == (2, 10), (method, out.shape)

    dec = quantize_decoder(TinyDecoder(vocab=16, dim=16, heads=2, depth=1, mlp_dim=32,
                                       max_seq=8, device=dev), group=8)
    logits, _ = dec.forward(torch.zeros((2,), dtype=torch.int64, device=dev),
                            dec.init_cache(), 0)
    assert logits.shape == (2, 16), logits.shape
    print("micronet_tpu_torch is ready")
