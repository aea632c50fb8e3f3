"""Every file the benchmark names loads by its name, and a cell and a
metric can be added from files alone."""

import json
import shutil

import pytest

from portbench import harness

from ._tiny import drive, tiny_run

BENCH = harness.load_bench()


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    chips4 = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(chips4) <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_load(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    run = harness.make_run(cell, 1, 1.0, False, 0.0)
    assert (run.spec["config"], run.spec["traffic"], run.spec["chips"]) == (
        entry["config"], entry["traffic"], entry["chips"])
    cfg = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert harness.load_json("..", cfg["file"]) == run.config
    assert sorted(cfg["reduced"]) == sorted(run.config["reduced"])
    assert callable(harness.traffic_runner(run.traffic["runner"]).run)
    for trace in (False, True):
        assert harness.metric_names(BENCH, cell, trace)


@pytest.mark.parametrize("metric", [(m["name"], "end_to_end") for m in BENCH["end_to_end"]]
                         + [(m["name"], "layers") for m in BENCH["per_layer"]])
def test_metric_reader_loads(metric):
    name, folder = metric
    assert callable(harness.load_module(folder, name).read)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_cells_report_what_they_move(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    for cell in m["workloads"]:
        assert m["moves"] in [n for n, _ in harness.metric_names(BENCH, cell, False)]


def test_a_cell_and_a_metric_from_files_alone(tmp_path):
    """A copy of the harness's files plus a new configuration, mix, cell
    and per-layer metric, none of the old files edited, runs end to end."""
    root = tmp_path / "portbench"
    shutil.copytree(harness.HERE, root, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    cfg = json.loads((root / "configs" / "ningc_w4a4.json").read_text())
    cfg.update(name="ningc_w8a8", quant={"a_bits": 8, "w_bits": 8, "bn_fuse": True})
    (root / "configs" / "ningc_w8a8.json").write_text(json.dumps(cfg))
    (root / "traffic" / "engine_b4.json").write_text(json.dumps(
        {"runner": "engine_closed", "batch": 4, "pool": 2, "calib_steps": 2, "calib_batch": 4,
         "trace_calls": 2}))
    (root / "workloads" / "ningc_w8a8.engine_b4.json").write_text(json.dumps(
        {"config": "ningc_w8a8", "traffic": "engine_b4", "chips": 1,
         "limits": {"logit_gap": 0.1, "top1_regret": 0.1}}))
    (root / "layers" / "calls_in_window.py").write_text(
        "def read(run):\n    return run.window.get('calls')\n")
    bench = dict(BENCH, per_layer=BENCH["per_layer"] + [
        {"name": "calls_in_window", "unit": "calls", "better": "higher",
         "source": "host_clock", "layer": "device", "moves": "infer_img_per_s",
         "workloads": ["ningc_w8a8.engine_b4"]}])
    bench["end_to_end"] = [dict(m, workloads=m["workloads"] + ["ningc_w8a8.engine_b4"])
                           if m["name"].startswith("infer") else m for m in BENCH["end_to_end"]]
    run = harness.make_run("ningc_w8a8.engine_b4", 3, 0.2, False, 0.0, device="cpu", root=root)
    run.config["model"]["kwargs"] = {"cfg": [64] * 8}
    run.config["widths"] = [64] * 8
    drive(run)
    assert run.correct
    got = harness.read_metrics(run, harness.metric_names(bench, run.cell, False))
    assert {"infer_img_per_s", "infer_call_p95_ms", "setup_s"} <= set(got)
    run.trace = True
    got = harness.read_metrics(run, harness.metric_names(bench, run.cell, True))
    assert got["calls_in_window"]["value"] == run.attempted


def test_engine_run_result_line():
    run = drive(tiny_run("resnet18_w8a8.engine_b512", trace=True))
    out = harness.result(run, {})
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["checks"]) == {"logit_gap", "top1_regret", "logit_mean_gap"}
