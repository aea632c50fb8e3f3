"""The sharded engine (``build_engine(mesh=)``) and the training half of
``graft_entry.dryrun_multichip`` in two gloo processes on the CPU."""

import numpy as np

from _torch_parallel_workers import engine_worker, spawn
from micronet_tpu_torch.graft_entry import dryrun_multichip


def test_sharded_engine_equals_single_process(tmp_path):
    """ResNet W8A8 (K1's twin in the fc, residual adds, chained int8) and
    NIN-GC W4A4 (grouped, nibble-packed): at dp = 2 every request (padded,
    exact, chunked) equals the single-process engine bit for bit, at tp =
    2 within 1e-5, as the JAX package's mesh engine is held
    (``tests/test_deploy.py``)."""
    spawn(engine_worker, tmp_path)
    with np.load(tmp_path / "engine.npz") as z:
        assert set(z.files) == {"resnet", "nin_gc"}


def test_dryrun_multichip_training_half():
    dryrun_multichip(2, device="cpu")
