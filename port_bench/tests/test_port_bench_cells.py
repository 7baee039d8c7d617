"""Cells and metrics are found by name: one added as files alone runs; and
``BENCHMARK.json`` keeps to the form that its readers expect."""

import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from port_bench import harness, run

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_resolves_to_its_files():
    b = bench()
    for w in b["workloads"]:
        cell = harness.resolve(ROOT, w["name"])
        assert cell.scene_path.is_file()
        assert harness.driver(cell).Driver.unit in ("frame", "step")
        assert cell.limits and all(v > 0 for v in cell.limits.values())
        assert any(m["name"] == "setup_s" for m in cell.end_to_end) and len(cell.end_to_end) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(harness.reader(ROOT, m["name"]))
            assert any(e["name"] == m["moves"] for e in cell.end_to_end)


def test_benchmark_json_keeps_its_form():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(b["paths"][0] + "/") and (ROOT / c["file"]).is_file()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) - {"workloads"} <= {"name", "unit", "better", "bound", "source", "layer",
                                          "moves"}
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert 1 <= b["run_seconds"] <= 51


def test_a_cell_and_a_metric_added_as_files_alone_are_picked_up(tmp_path):
    """A new configuration, mix, cell and per-layer metric, written as new
    files and entries beside the others, runs with no edit to any file."""
    for sub in ("configs", "mixes", "cells", "metrics"):
        shutil.copytree(ROOT / "port_bench" / sub, tmp_path / "port_bench" / sub)
    b = bench()
    base = tmp_path / "port_bench"
    config = json.loads((base / "configs" / "dingdong-1280x720.json").read_text())
    config.update(name="cubic-tiny", scene="cubic-tiny.yml", width=16, height=8)
    (base / "configs" / "cubic-tiny.json").write_text(json.dumps(config))
    shutil.copy(ROOT / "scenes" / "cubic.yml", base / "configs" / "cubic-tiny.yml")
    mix = json.loads((base / "mixes" / "view.json").read_text())
    mix.update(session_frames=16, warm_frames=2, sample_frames=2, trace_units=3)
    (base / "mixes" / "view_short.json").write_text(json.dumps(mix))
    (base / "cells" / "cubic.view_short.json").write_text(json.dumps({"limits": {"bad_px_share": 1.0}}))
    (base / "metrics" / "frames_traced.view.py").write_text(
        "def read(trace):\n    return float(trace.units)\n")
    b["configs"].append({"name": "cubic-tiny", "source": "tests", "reduced": [], "why": "test",
                         "file": "port_bench/configs/cubic-tiny.json"})
    b["workloads"].append({"name": "cubic.view_short", "config": "cubic-tiny",
                           "traffic": "view_short", "chips": 1, "why": "test"})
    for m in b["end_to_end"]:
        if "workloads" in m and "dingdong.view" in m["workloads"]:
            m["workloads"].append("cubic.view_short")
    b["per_layer"].append({"name": "frames_traced.view", "unit": "frames", "better": "higher",
                           "source": "device_trace", "layer": "device", "moves": "frame_ms",
                           "workloads": ["cubic.view_short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    cell = harness.resolve(tmp_path, "cubic.view_short")
    cell.size = (16, 8)
    out = run.run_cell(cell, 5, 0.05, True, torch.device("cpu"))
    assert out["metrics"]["frames_traced.view"]["value"] == 3.0
    assert out["correct"] and out["attempted"] >= 3
    plain = run.run_cell(cell, 5, 0.05, False, torch.device("cpu"))
    assert set(plain["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s"}


@pytest.mark.parametrize("argv", [["--workload", "dingdong.view", "--seed", "1", "--seconds", "1"]])
def test_no_card_no_result(argv, capsys, monkeypatch):
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(run, "cache_env", lambda root: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(argv) == 2
    assert capsys.readouterr().out == ""
