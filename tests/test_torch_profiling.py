"""``utils/profiling.py`` of the port against the JAX package's: the
roofline arithmetic on identical peaks, the H100 table, card detection
and the trace file."""

import dataclasses
import json

import pytest
import torch

from micronet_tpu.utils import profiling as jprof
from micronet_tpu_torch.utils import profiling as tprof


def _pair(bf16, int8, hbm):
    return (jprof.ChipSpec("x", bf16_tflops=bf16, int8_tops=int8, hbm_gbps=hbm),
            tprof.ChipSpec("x", bf16_tflops=bf16, int8_tops=int8, hbm_gbps=hbm, f32_tflops=1.0))


@pytest.mark.parametrize("dtype", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("seconds,flops,nbytes", [
    (1e-3, 1e9, 1e6), (2.5e-4, 0.0, 3.35e8), (0.0, 1e12, 1e9), (7e-6, 4e10, 0.0),
    (1.0, 0.0, 0.0), (3e-5, 1.979e10, 1e5)])
@pytest.mark.parametrize("peaks", [(989, 1979, 3350), (197, 394, 819), (756, 1513, 2000)])
def test_roofline_equals_jax_on_identical_peaks(dtype, seconds, flops, nbytes, peaks):
    jchip, tchip = _pair(*peaks)
    kw = dict(flops=flops, bytes_accessed=nbytes, dtype=dtype)
    assert tprof.roofline(seconds, chip=tchip, **kw) == jprof.roofline(seconds, chip=jchip, **kw)


def test_f32_takes_the_cards_own_fp32_peak():
    """f32 differs on purpose: the FP32 units outside the tensor cores
    (67 TFLOP/s on an H100 SXM), not the JAX package's TPU rule bf16 / 8."""
    chip = tprof.CHIPS["h100_sxm"]
    r = tprof.roofline(2.0, flops=67e12, dtype="f32", chip=chip)
    assert r["bound_seconds"] == pytest.approx(1.0) and r["fraction_of_roofline"] == 0.5
    assert r["binding"] == 1.0


def test_h100_table():
    sxm, pcie = tprof.CHIPS["h100_sxm"], tprof.CHIPS["h100_pcie"]
    assert (sxm.bf16_tflops, sxm.int8_tops, sxm.hbm_gbps, sxm.f32_tflops) == (989, 1979, 3350, 67)
    assert sxm.int4_tops == sxm.int8_tops and pcie.int4_tops == pcie.int8_tops
    assert {f.name for f in dataclasses.fields(tprof.ChipSpec)} >= {
        f.name for f in dataclasses.fields(jprof.ChipSpec)}


@pytest.mark.parametrize("name,key", [("NVIDIA H100 80GB HBM3", "h100_sxm"),
                                      ("NVIDIA H100 PCIe", "h100_pcie"),
                                      ("NVIDIA A100-SXM4-80GB", "h100_sxm")])
def test_current_chip_reads_the_device_name(monkeypatch, name, key):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)
    assert tprof.current_chip() is tprof.CHIPS[key]


def test_current_chip_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tprof.current_chip("h100_pcie") is tprof.CHIPS["h100_pcie"]


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with tprof.trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "tr").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
