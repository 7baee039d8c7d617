"""Cells, configurations, mixes and metrics, found by name.

``BENCHMARK.json`` at the root names every cell (``workloads``), its
configuration and its traffic mix. Each of those is a file of its own, found
from the name alone, so that a cell or a metric is added by adding files and
entries:

* ``port_bench/configs/<config>.json``: the configuration as it is run (the
  ``file`` of its entry), its scene YAML beside it;
* ``port_bench/mixes/<traffic>.json``: the mix's parameters, and the name of
  the driver (``port_bench/drivers/<driver>.py``) that reads them;
* ``port_bench/cells/<workload>.json``: the limits of the numbers that
  decide ``correct`` in that cell;
* ``port_bench/metrics/<metric>.py``, or where there is none
  ``port_bench/metrics/<base>.py`` of the name's part before its first
  ``.``: a per-layer metric's reader, ``read(trace) -> float | None``, so
  that ``device_idle_share.view`` and ``device_idle_share.fit`` read alike.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

PACKAGE = "port_bench"
# top-level modules that no run may load: the JAX package and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_ray_tracer")
SMI_FIELDS = ("name", "clocks.sm", "clocks.max.sm", "power.draw", "power.limit",
              "temperature.gpu")


@dataclasses.dataclass
class Cell:
    root: Path
    name: str
    workload: dict     # its entry in BENCHMARK.json
    config: dict       # its configuration's entry
    setting: dict      # the configuration's file
    mix: dict          # the traffic mix's file
    limits: dict       # the cell's file: the limit of each number compared
    end_to_end: list   # the end-to-end metrics' entries this cell reports
    per_layer: list    # the per-layer metrics' entries this cell reports
    size: tuple | None = None  # (width, height) in place of the scene's, for CPU tests

    @property
    def scene_path(self) -> Path:
        return (self.root / self.config["file"]).parent / self.setting["scene"]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def no_span(name: str):
    """The span of a run without a trace: none."""
    return contextlib.nullcontext()


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def resolve(root: Path, name: str) -> Cell:
    """The cell ``name`` of the benchmark at ``root``; KeyError if none."""
    bench = read_json(root / "BENCHMARK.json")
    workload = next((w for w in bench["workloads"] if w["name"] == name), None)
    if workload is None:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    config = next(c for c in bench["configs"] if c["name"] == workload["config"])
    base = root / PACKAGE
    return Cell(root=root, name=name, workload=workload, config=config,
                setting=read_json(root / config["file"]),
                mix=read_json(base / "mixes" / f"{workload['traffic']}.json"),
                limits=read_json(base / "cells" / f"{name}.json")["limits"],
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def driver(cell: Cell):
    """The module that drives the cell's mix."""
    return importlib.import_module(f"{PACKAGE}.drivers.{cell.mix['driver']}")


def reader(root: Path, metric: str):
    """``read(trace)`` of the per-layer metric ``metric``: its own file, or
    that of its base name."""
    path = root / PACKAGE / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = path.with_name(f"{metric.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(f"{PACKAGE}_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def smi() -> dict:
    """The card's name, clocks, power and temperature from nvidia-smi (each
    field as it prints it), or {"error": ...} where it cannot be read."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={','.join(SMI_FIELDS)}",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return {"error": str(exc)[:200]}
    return dict(zip(SMI_FIELDS, (v.strip() for v in out.strip().splitlines()[0].split(","))))


def forbidden_loaded() -> list:
    """The forbidden top-level modules that ``sys.modules`` holds, compared
    by their whole top-level names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def within(compared: dict) -> bool:
    """Whether every number compared is finite and at most its limit."""
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values())
