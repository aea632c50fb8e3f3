"""The gap between the W8A8 integer engine and its fake-quant model on
full-depth ResNet-50, in the JAX package and in the port, from the same
float weights and the same calibration batches, on the CPU:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/_torch_resnet50_gap.py

(about 6 minutes, mostly JAX's eager fake-quant ResNet-50). It prints
each package's max |engine - fake-quant| over 8 images, the largest logit
and the rows whose argmax agree. ``chip_smoke.RESNET50_FQ_TOL`` comes from
it: at this depth the JAX package's own engine is further from its
fake-quant model than ``chip_smoke.FQ_TOL``.
"""

import time

import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from _torch_engine_flow import _flat, _x, run
from micronet_tpu.infer import freeze_int as jfreeze
from micronet_tpu.infer import fuse_bn_iao as jfuse
from micronet_tpu.models import resnet as jres
from micronet_tpu.nn import eval_mode as jeval
from micronet_tpu.nn import prepare as jprepare
from micronet_tpu.nn import train_mode as jtrain
from micronet_tpu.quant.config import QuantConfig as JQuantConfig
from micronet_tpu_torch.infer import freeze_int, fuse_bn_iao
from micronet_tpu_torch.interop import cnn_state_from_numpy
from micronet_tpu_torch.models import resnet as tres
from micronet_tpu_torch.nn import eval_mode, prepare, train_mode
from micronet_tpu_torch.quant.config import QuantConfig

CFG = dict(a_bits=8, w_bits=8, bn_fuse=True)


def report(what, engine_out, fused_out, t0):
    print(f"{what}: engine vs fake-quant max|diff| {np.abs(engine_out - fused_out).max():.4f}, "
          f"max|logit| {np.abs(fused_out).max():.4f}, argmax equal "
          f"{(engine_out.argmax(-1) == fused_out.argmax(-1)).tolist()} "
          f"({time.perf_counter() - t0:.0f} s)", flush=True)


def main():
    t0 = time.perf_counter()
    jm = jres.resnet50(rngs=nnx.Rngs(0))
    tm = tres.resnet50(device="cpu")
    tm.load_state_dict(cnn_state_from_numpy(_flat(jm), tm))
    x = _x(99, (8, 32, 32, 3))
    calib = [_x(10 + i, (16, 32, 32, 3)) for i in range(4)]

    tq = train_mode(prepare(tm, QuantConfig(**CFG), device="cpu"))
    for c in calib:
        run(tq, c)
    tfused = eval_mode(fuse_bn_iao(eval_mode(tq), QuantConfig(**CFG), device="cpu"))
    teng = eval_mode(freeze_int(tfused, example_input=torch.from_numpy(x[:1]), device="cpu"))
    report("port", run(teng, x), run(tfused, x), t0)

    jq = jprepare(jm, JQuantConfig(**CFG), method="iao")
    jtrain(jq)
    for c in calib:
        jq(jnp.asarray(c))
    jeval(jq)
    jfused = jfuse(jq, JQuantConfig(**CFG))
    jeval(jfused)
    jeng = jfreeze(jfused, example_input=jnp.asarray(x[:1]))
    jeval(jeng)
    report("jax", np.asarray(jeng(jnp.asarray(x))), np.asarray(jfused(jnp.asarray(x))), t0)


if __name__ == "__main__":
    main()
