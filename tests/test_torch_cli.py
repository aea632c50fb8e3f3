"""The port's CLI end to end on the CPU (``--device cpu``), on the
synthetic set at 256 images (``MICRONET_SYNTHETIC_SIZE``) with narrow
widths: ``train`` -> ``bn-fuse`` -> ``model-test`` (EQUIVALENCE OK) ->
``freeze-int`` for IAO; DoReFa and wbwtab through ``model-test``; KL PTQ
with its calibration cache -> ``freeze-int``; ``-sr`` -> ``prune`` ->
``train --prune_quant`` (and ``--prune_qaft``); resuming; the
package self-tests' ready line; and the default device (CUDA, which
raises without a card)."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import micronet_tpu_torch
from micronet_tpu_torch import cli
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
GC = "32,32,32,32,32,32,32,32"  # NIN-GC's narrowest widths (groups of 32)
NIN = "16,16,16,16,16,16,16,16"
SMALL = ["--device", "cpu", "--train_batch_size", "32"]


@pytest.fixture(autouse=True)
def _small_set(monkeypatch):
    monkeypatch.setenv("MICRONET_SYNTHETIC_SIZE", "256")


def _run(capsys, *argv):
    rc = cli.main([str(a) for a in argv])
    out = capsys.readouterr().out
    return rc, out


def test_iao_train_fuse_model_test_freeze(tmp_path, capsys):
    ck, fused, eng = tmp_path / "iao.npz", tmp_path / "fused.npz", tmp_path / "eng.npz"
    metrics = tmp_path / "m.jsonl"
    rc, out = _run(capsys, "train", *SMALL, "--method", "iao", "--bn_fuse", "--cfg", GC,
                   "--epochs", 2, "--save", ck, "--metrics", metrics, "--async_checkpoint")
    assert rc == 0 and "best acc" in out and ck.exists()
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    epochs = [r for r in rows if r["event"] == "epoch"]
    assert len(epochs) == 2 and len(epochs[0]["step_loss"]) == 8
    rc, out = _run(capsys, "bn-fuse", "--device", "cpu", "--bn_fuse", "--cfg", GC, "--model",
                   ck, "--save", fused, "--dump")
    assert rc == 0 and fused.exists() and (tmp_path / "fused_para.json").exists()
    assert "# module tree" in (tmp_path / "fused.txt").read_text()
    rc, out = _run(capsys, "model-test", "--device", "cpu", "--bn_fuse", "--cfg", GC, "--model",
                   ck, "--eval_batch_size", 64)
    assert rc == 0 and "EQUIVALENCE OK" in out
    rc, out = _run(capsys, "freeze-int", "--device", "cpu", "--bn_fuse", "--cfg", GC, "--model",
                   ck, "--save", eng)
    assert rc == 0 and eng.exists()
    with np.load(eng) as z:
        assert any(k.endswith("w_q/.value") for k in z.files)


def test_asym_w4a4_fl8_train_and_freeze(tmp_path, capsys):
    """The ACC_TABLE recipe ``iao_w4a4_asym_fl8`` through the CLI: ``train
    --q_type 1`` with 8-bit first and last layers, then ``freeze-int``
    with the same flags builds the asymmetric engine. The saved engine
    holds the zero points under the JAX package's names, and equals the
    engine rebuilt from the checkpoint, key for key."""
    from micronet_tpu_torch.infer import freeze_int, fuse_bn_iao
    from micronet_tpu_torch.infer.engine import IntConv2d
    from micronet_tpu_torch.models import nin_gc
    from micronet_tpu_torch.nn import eval_mode, prepare
    from micronet_tpu_torch.quant.config import QuantConfig
    from micronet_tpu_torch.train import load_state
    from micronet_tpu_torch.train.checkpoint import state_to_arrays

    flags = ["--method", "iao", "--bn_fuse", "--q_type", 1, "--a_bits", 4, "--w_bits", 4,
             "--first_layer_a_bits", 8, "--first_layer_w_bits", 8, "--last_layer_a_bits", 8,
             "--last_layer_w_bits", 8, "--cfg", GC]
    ck, eng = tmp_path / "asym.npz", tmp_path / "eng.npz"
    rc, out = _run(capsys, "train", *SMALL, *flags, "--epochs", 1, "--save", ck)
    assert rc == 0 and "best acc" in out
    rc, _ = _run(capsys, "freeze-int", "--device", "cpu", *flags[2:], "--model", ck, "--save",
                 eng)
    assert rc == 0
    cfg = QuantConfig(a_bits=4, w_bits=4, q_type=1, bn_fuse=True, first_layer_a_bits=8,
                      first_layer_w_bits=8, last_layer_a_bits=8, last_layer_w_bits=8)
    q = prepare(nin_gc.Net(cfg=[32] * 8, device="cpu"), cfg, device="cpu")
    load_state(str(ck), q)
    engine = freeze_int(eval_mode(fuse_bn_iao(q, cfg, device="cpu")),
                        example_input=torch.zeros((1, 32, 32, 3)), device="cpu")
    convs = [m for m in engine.modules() if isinstance(m, IntConv2d)]
    assert len(convs) == 9 and not any(m.symmetric or m.w_symmetric for m in convs)
    with np.load(eng) as z:
        saved = {k: z[k] for k in z.files}
    assert any(k.endswith("/act_zero_point/.value") for k in saved)
    assert any(k.endswith("/w_zp/.value") for k in saved)
    rebuilt = state_to_arrays(engine)
    assert {k for k in saved if k.startswith("model/")} == {f"model/{k}" for k in rebuilt}
    for k, v in rebuilt.items():
        np.testing.assert_array_equal(saved[f"model/{k}"], v, err_msg=k)


@pytest.mark.parametrize("method,extra", [("dorefa", []), ("wbwtab", ["--W", 3, "--A", 2])])
def test_low_bit_train_and_model_test(tmp_path, capsys, method, extra):
    ck = tmp_path / f"{method}.npz"
    rc, _ = _run(capsys, "train", *SMALL, "--method", method, *extra, "--cfg", GC, "--epochs", 1,
                 "--save", ck)
    assert rc == 0
    rc, out = _run(capsys, "model-test", "--device", "cpu", "--method", method, *extra, "--cfg",
                   GC, "--model", ck, "--eval_batch_size", 64)
    assert rc == 0 and "EQUIVALENCE OK" in out


def test_wbwtab_two_stage_and_grad_accum(tmp_path, capsys):
    rc, out = _run(capsys, "train", *SMALL, "--method", "wbwtab", "--two_stage", 1, "--cfg", GC,
                   "--epochs", 1, "--grad_accum", 2, "--save", tmp_path / "w.npz")
    assert rc == 0 and "two-stage: stage-1" in out


def test_kl_ptq_cache_and_freeze(tmp_path, capsys):
    ck, cache, eng = tmp_path / "ptq.npz", tmp_path / "calib.json", tmp_path / "eng.npz"
    args = ["--method", "iao", "--ptq", "--ptq_observer", "kl", "--cfg", GC]
    rc, out = _run(capsys, "train", *SMALL, *args, "--calib_cache", cache, "--epochs", 5,
                   "--ptq_control", "--ptq_batch", 3, "--save", ck)
    assert rc == 0 and "resolved 12 thresholds" in out and out.count("epoch 1 done") == 1
    assert "epoch 2" not in out  # --ptq_control caps PTQ at 2 epochs
    table = json.loads(cache.read_text())
    assert len(table) == 12 and all(v > 0 for v in table.values())
    rc, _ = _run(capsys, "freeze-int", "--device", "cpu", "--ptq", "--ptq_observer", "kl",
                 "--cfg", GC, "--model", ck, "--save", eng)
    assert rc == 0 and eng.exists()


def test_sparsity_prune_then_quantize(tmp_path, capsys):
    sr, pruned = tmp_path / "sr.npz", tmp_path / "pruned.npz"
    rc, _ = _run(capsys, "train", *SMALL, "--method", "float", "-sr", "--s", 1e-4,
                 "--model_type", 0, "--cfg", NIN, "--epochs", 1, "--save", sr)
    assert rc == 0
    rc, out = _run(capsys, "prune", "--device", "cpu", "--model_type", 0, "--cfg", NIN,
                   "--model", sr, "--save", pruned, "--percent", 0.5, "--normal_regular", 1)
    assert rc == 0 and "pruned_ratio" in out
    cfg = json.loads(out.split("cfg: ")[1].splitlines()[0])
    with np.load(pruned) as z:
        assert json.loads(bytes(z["__header__"]).decode())["extra"]["cfg"] == cfg
    pq = tmp_path / "pq.npz"
    rc, _ = _run(capsys, "train", *SMALL, "--method", "iao", "--model_type", 0,
                 "--prune_quant", pruned, "--epochs", 1, "--save", pq)
    assert rc == 0
    rc, _ = _run(capsys, "train", *SMALL, "--method", "iao", "--model_type", 0, "--qaft",
                 "--prune_qaft", pq, "--epochs", 1, "--lr", 1e-4, "--save", tmp_path / "qaft.npz")
    assert rc == 0
    rc, out = _run(capsys, "prune", "--device", "cpu", "--model_type", 1, "--cfg", GC, "--gc")
    assert rc == 0 and "cfg: [" in out


def test_refine_and_auto_resume(tmp_path, capsys):
    fl = tmp_path / "float.npz"
    _run(capsys, "train", *SMALL, "--method", "float", "--cfg", GC, "--epochs", 1, "--save", fl)
    ck = tmp_path / "q.npz"
    rc, _ = _run(capsys, "train", *SMALL, "--refine", fl, "--cfg", GC, "--epochs", 1,
                 "--save", ck, "--auto_resume")
    assert rc == 0 and Path(str(ck) + ".latest.npz").exists()
    rc, out = _run(capsys, "train", *SMALL, "--cfg", GC, "--epochs", 2, "--save", ck,
                   "--auto_resume")
    assert rc == 0 and "resumed from" in out and "epoch 0 done" not in out


def test_self_tests_print_the_ready_line(capsys):
    micronet_tpu_torch.quant_test_manual(device="cpu")
    micronet_tpu_torch.quant_test_auto(device="cpu")
    assert capsys.readouterr().out.count("micronet_tpu_torch is ready") == 2


def test_default_device_is_cuda_and_deploy_raises(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["train", "--cfg", GC, "--epochs", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        micronet_tpu_torch.quant_test_manual()
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["deploy", "--cfg", GC])


def test_module_entry_point():
    res = subprocess.run([sys.executable, "-m", "micronet_tpu_torch.cli", "train", "--help"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "--prune_quant" in res.stdout and "--device" in res.stdout
