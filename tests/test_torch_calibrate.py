"""PTQ calibration in the port against the JAX package: the percentile
(histogram) and entropy observers field by field over a few batches,
``kl_threshold`` bit for bit, the native batched KL search against the
Python one, the calibration cache, and PTQ-prepared LeNet and ResNet
stages (``ptq_observer`` percentile and kl) against JAX's.

Tolerances: observers fed the same batches give ``max_val`` and
``absmax`` within 1e-6 relative (they are equal here) and equal
histogram counts. The entropy histogram counts each batch exactly in the
port; JAX's f32 scatter of 1.0 stops a bin at 2^24 within one batch
(ROADMAP.md, deliberate differences): both agree below that and part
above it, as the last observer test shows.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from micronet_tpu.models import LeNet as JLeNet
from micronet_tpu.nn import prepare as jprepare
from micronet_tpu.nn import train_mode as jtrain
from micronet_tpu.quant import calibrate as jcal
from micronet_tpu.quant import observers as jobs
from micronet_tpu.quant.config import QuantConfig as JQuantConfig
from micronet_tpu_torch.interop import cnn_state_from_numpy
from micronet_tpu_torch.models.lenet import LeNet
from micronet_tpu_torch.nn import prepare, qat_iao, train_mode
from micronet_tpu_torch.quant import calibrate as tcal
from micronet_tpu_torch.quant import observers as tobs
from micronet_tpu_torch.quant.config import QuantConfig
from micronet_tpu_torch.train import native_loader
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

STAT_RTOL = 1e-6


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _flat(module):
    return {path: np.asarray(v[...]) for path, v in nnx.state(module).flat_state()}


@pytest.mark.parametrize("percentile", [0.9999, 0.99, 0.5, 1.0, 1e-9])
def test_percentile_absmax_equals_jax(percentile):
    x = _np(1, (3, 17, 11, 5), 2.0)
    got = tobs.percentile_absmax(torch.from_numpy(x), percentile)
    assert float(got) == float(jobs.percentile_absmax(jnp.asarray(x), percentile))


def test_histogram_observer_over_batches():
    js = jobs.init_histogram_state((1,))
    ts = tobs.init_histogram_state((1,), device="cpu")
    for i in range(4):
        x = _np(10 + i, (4, 8, 8, 3), 1.0 + i)
        js = jobs.histogram_update(js, jnp.asarray(x), 0.999, 0.1)
        ts = tobs.histogram_update(ts, torch.from_numpy(x), 0.999, 0.1)
        np.testing.assert_allclose(ts.max_val.numpy(), np.asarray(js.max_val), rtol=STAT_RTOL)
        assert float(ts.min_val) == 0.0 and bool(ts.initialized)


def test_entropy_observer_field_by_field():
    """Batches whose range grows (the stored counts move onto the wider
    grid), shrinks and stays: counts equal, absmax equal."""
    js = jobs.init_entropy_state(2048)
    ts = tobs.init_entropy_state(2048, device="cpu")
    for i, scale in enumerate((1.0, 3.0, 0.5, 3.0, 7.5)):
        x = _np(20 + i, (4, 16, 16, 3), scale)
        js = jobs.entropy_update(js, jnp.asarray(x))
        ts = tobs.entropy_update(ts, torch.from_numpy(x))
        np.testing.assert_allclose(float(ts.absmax), float(js.absmax), rtol=STAT_RTOL)
        np.testing.assert_array_equal(ts.counts.numpy(), np.asarray(js.counts))
    assert float(ts.counts.sum()) == pytest.approx(5 * x.size, rel=1e-6)


@pytest.mark.parametrize("ratio", [1.0, 0.999, 0.5, 0.123, 1e-3])
def test_rescale_counts_equals_jax(ratio):
    counts = np.abs(_np(3, (2048,), 50.0)).round()
    got = tobs._rescale_counts(torch.from_numpy(counts), torch.tensor(ratio, dtype=torch.float32))
    want = jobs._rescale_counts(jnp.asarray(counts), jnp.float32(ratio))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_entropy_counts_exact_past_two_to_the_24():
    """One bin of one batch past 2^24 values: the port counts all of them,
    JAX's f32 scatter stops at 2^24. Below that both agree (above)."""
    n = 2**24 + 8
    x = np.zeros(n, np.float32)
    x[:4] = 1.0
    got = tobs._hist_absx(torch.from_numpy(x), torch.tensor(1.0), 16)
    want = np.asarray(jobs._hist_absx(jnp.asarray(x), jnp.float32(1.0), 16))
    assert float(got[0]) == n - 4 and float(got[-1]) == 4.0
    assert want[0] == 2.0**24 and want[-1] == 4.0


def _histograms():
    rng = np.random.default_rng(5)
    return [
        np.histogram(np.abs(rng.standard_normal(20000)), bins=2048)[0].astype(np.float64),
        np.histogram(np.abs(rng.laplace(size=50000)), bins=2048)[0].astype(np.float64),
        np.concatenate([rng.integers(0, 9, 300), np.zeros(1748)]).astype(np.float64),
        np.zeros(2048),
    ]


@pytest.mark.parametrize("i", range(4))
def test_kl_threshold_bit_equal(i):
    counts = _histograms()[i]
    for absmax in (4.0, 0.37):
        assert tcal.kl_threshold(counts, absmax) == jcal.kl_threshold(counts, absmax)
    assert tcal.kl_threshold(counts[:100], 1.0) == jcal.kl_threshold(counts[:100], 1.0)


def test_native_batched_kl_equals_python():
    if not native_loader.available():
        pytest.fail("native/libmicronet_host.so did not build (make -C native)")
    counts = np.stack(_histograms())
    absmax = np.array([4.0, 9.5, 0.25, 1.0])
    got = native_loader.kl_thresholds_batch(counts, absmax)
    want = [tcal.kl_threshold(c, a) for c, a in zip(counts, absmax)]
    assert got is not None and list(got) == want


def _lenet_pair(cfg_kw, seed=0):
    jm = JLeNet(rngs=nnx.Rngs(seed))
    tm = LeNet(device="cpu")
    tm.load_state_dict(cnn_state_from_numpy(_flat(jm)))
    jq = jtrain(jprepare(jm, JQuantConfig(**cfg_kw), method="iao"))
    tq = train_mode(prepare(tm, QuantConfig(**cfg_kw), method="iao", device="cpu"))
    return jq, tq


def _quantizers(model):
    return {n.replace(".", "/"): m for n, m in model.named_modules()
            if isinstance(m, qat_iao.FakeQuantizer)}


def test_ptq_percentile_lenet_matches_jax():
    """Percentile PTQ streams fake-quantized activations; the observers'
    max_val, then scale, agree with JAX's within 1e-6 relative."""
    kw = dict(a_bits=8, w_bits=8, ptq=True, percentile=0.999)
    jq, tq = _lenet_pair(kw)
    for i in range(3):
        x = _np(40 + i, (4, 32, 32, 3))
        jout = np.asarray(jq(jnp.asarray(x)))
        with torch.no_grad():
            tout = tq(torch.from_numpy(x)).numpy()
    assert all(q.observer == "histogram" for n, q in _quantizers(tq).items() if "activation" in n)
    assert all(q.symmetric for q in _quantizers(tq).values())
    jflat = {"/".join(map(str, k)): v for k, v in _flat(jq).items()}
    for name, q in _quantizers(tq).items():
        for field in ("max_val", "scale"):
            want = jflat[f"{name}/{field}"]
            got = getattr(q, field).numpy()
            np.testing.assert_allclose(got.reshape(want.shape[::-1]).T if got.ndim == 4 else got,
                                       want, rtol=STAT_RTOL, err_msg=f"{name}/{field}")
    np.testing.assert_allclose(tout, jout, atol=0.05 * max(1, np.abs(jout).max()))


def test_kl_ptq_lenet_matches_jax_and_cache_round_trip(tmp_path):
    """KL PTQ streams the float network; LeNet's first quantizer sees the
    same input in both packages, so its histogram is equal count for
    count; the later ones see f32 sums in another order, so a value on a
    bin edge may move one bin, and the resolved thresholds agree within
    two bin widths. The calibration table written by the port reads back
    into a fresh model (and into JAX's)."""
    kw = dict(a_bits=8, w_bits=8, ptq=True, ptq_observer="kl")
    jq, tq = _lenet_pair(kw)
    for i in range(3):
        x = _np(60 + i, (4, 32, 32, 3))
        jout = np.asarray(jq(jnp.asarray(x)))
        with torch.no_grad():
            tout = tq(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tout, jout, atol=1e-4)  # the float net streams
    jflat = {"/".join(map(str, k)): v for k, v in _flat(jq).items()}
    first = "features/layers/0/activation_quantizer"
    np.testing.assert_array_equal(_quantizers(tq)[first].ent_counts.numpy(),
                                  jflat[first + "/ent_counts"])
    for name, q in _quantizers(tq).items():
        if q.observer == "entropy":
            assert float(q.ent_counts.double().sum()) == pytest.approx(
                float(jflat[f"{name}/ent_counts"].astype(np.float64).sum()), rel=STAT_RTOL)
            np.testing.assert_allclose(float(q.ent_absmax), jflat[f"{name}/ent_absmax"],
                                       rtol=STAT_RTOL)
    cache = str(tmp_path / "calib.json")
    table = tcal.finalize_entropy_calibration(tq, cache=cache)
    jtable = jcal.finalize_entropy_calibration(jq)
    assert set(table) == set(jtable) and len(table) == 7
    for k, v in table.items():
        width = jtable[k] / 2048 * 2
        assert abs(v - jtable[k]) <= width, (k, v, jtable[k])
    # a fresh (unstreamed) model takes its thresholds from the file
    _, fresh = _lenet_pair(kw)
    assert tcal.finalize_entropy_calibration(fresh, cache=cache) == table
    for name, q in _quantizers(fresh).items():
        if q.observer == "entropy":
            assert float(q.max_val) == np.float32(table[name]) and bool(q.initialized)
    jfresh, _ = _lenet_pair(kw)
    assert jcal.finalize_entropy_calibration(jfresh, cache=cache) == table
    with open(cache) as f:
        assert json.load(f) == table
    # a table missing a quantizer is refused
    (tmp_path / "bad.json").write_text(json.dumps({first: 1.0}))
    _, fresh = _lenet_pair(kw)
    with pytest.raises(KeyError, match="no entry"):
        tcal.finalize_entropy_calibration(fresh, cache=str(tmp_path / "bad.json"))


def test_kl_ptq_resnet_union_scales():
    """QuantAdd under KL PTQ: its side observers stream, its shared scale
    is refreshed from their resolved thresholds."""
    from micronet_tpu_torch.models.resnet import BasicBlock, ResNet

    cfg = QuantConfig(a_bits=8, w_bits=8, ptq=True, ptq_observer="kl", bn_fuse=True)
    q = train_mode(prepare(ResNet(BasicBlock, [1, 1, 1, 1], device="cpu"), cfg, device="cpu"))
    with torch.no_grad():
        for i in range(2):
            q(torch.from_numpy(_np(70 + i, (2, 16, 16, 3))))
    table = tcal.finalize_entropy_calibration(q)
    add = q.conv2_x.layers[0].add
    aq = add.activation_quantizer
    assert not hasattr(aq, "ent_counts") and add.observer_res.observer == "entropy"
    want = max(table["conv2_x/layers/0/add/observer_res"],
               table["conv2_x/layers/0/add/observer_shortcut"])
    assert float(aq.max_val) == np.float32(want) and bool(aq.initialized)
    assert float(aq.scale) == pytest.approx(want / 127.5, rel=1e-6)


def test_lenet_engine_runs_k1_for_every_linear(monkeypatch):
    """``freeze_int`` on a KL-calibrated LeNet (the CLI's ``freeze-int``
    with its zeros example input): flatten -> fc takes K1's route, each of
    the three Linear layers an ``IntLinear`` calling ``int8_matmul_dequant``
    once a forward (the CPU twin here); the engine agrees with the fused
    fake-quant model within the JAX package's engine bound (0.1)."""
    from micronet_tpu_torch.infer import freeze_int, fuse_bn_iao
    from micronet_tpu_torch.infer.engine import IntLinear
    from micronet_tpu_torch.nn import eval_mode
    from micronet_tpu_torch.ops import int_matmul

    cfg = QuantConfig(a_bits=8, w_bits=8, ptq=True, ptq_observer="kl")
    _, tq = _lenet_pair(dict(a_bits=8, w_bits=8, ptq=True, ptq_observer="kl"))
    with torch.no_grad():
        for i in range(3):
            tq(torch.from_numpy(_np(80 + i, (4, 32, 32, 3))))
    tcal.finalize_entropy_calibration(tq)
    fused = eval_mode(fuse_bn_iao(tq, cfg, device="cpu"))
    engine = eval_mode(freeze_int(fused, example_input=torch.zeros((1, 32, 32, 3)),
                                  device="cpu"))
    assert [type(engine.classifier.layers[i]) for i in (0, 2, 4)] == [IntLinear] * 3
    calls = []
    orig = int_matmul.int8_matmul_dequant

    def counted(*a, **k):
        calls.append(a[0].shape)
        return orig(*a, **k)

    monkeypatch.setattr(int_matmul, "int8_matmul_dequant", counted)
    x = torch.from_numpy(_np(90, (4, 32, 32, 3)))
    with torch.no_grad():
        out, ref = engine(x), fused(x)
    assert calls == [(4, 400), (4, 120), (4, 84)]
    torch.testing.assert_close(out, ref, rtol=0, atol=0.1)
