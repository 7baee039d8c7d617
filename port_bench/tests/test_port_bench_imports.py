"""Nothing the benchmark runs imports JAX or the JAX package, and its
reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import harness

ROOT = Path(__file__).resolve().parents[2]
PACKAGE = ROOT / "port_bench"
SOURCES = sorted(p for p in PACKAGE.rglob("*.py") if "tests" not in p.relative_to(PACKAGE).parts)


def imported(path: Path) -> set:
    """The top-level names of every absolute import in ``path``, and of the
    package that each relative import resolves to."""
    tree = ast.parse(path.read_text())
    parts = path.relative_to(ROOT).with_suffix("").parts
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                names.add(node.module.split(".")[0])
            else:
                base = parts[:len(parts) - node.level]
                assert base, f"{path}: relative import out of the repository"
                names.add(base[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PACKAGE)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not imported(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((PACKAGE / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PACKAGE)))
def test_the_reference_imports_nothing_of_the_program(path):
    names = imported(path)
    assert "tpu_ray_tracer_torch" not in names and not names & set(harness.FORBIDDEN)
    tree = ast.parse(path.read_text())
    depth = len(path.relative_to(PACKAGE / "reference").parts)
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert node.level <= depth, f"{path}: a relative import leaves the reference"


def test_no_source_reads_the_jax_benchs_files():
    for path in SOURCES:
        text = path.read_text()
        assert "bench_goldens" not in text and "tools/" not in text and '"bench.py"' not in text


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, port_bench.run, port_bench.calibrate, port_bench.drivers.view, "
            "port_bench.drivers.fit, port_bench.reference.fit, port_bench.reference.render.bounds, "
            "tpu_ray_tracer_torch.models.loader, tpu_ray_tracer_torch.render.kernel_backend, "
            "tpu_ray_tracer_torch.diff.inverse; "
            "from port_bench import harness; print(','.join(harness.forbidden_loaded()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=240, check=True)
    assert out.stdout.strip() == ""


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu_ray_tracer_torch_fake", object())
    monkeypatch.delitem(sys.modules, "tpu_ray_tracer", raising=False)
    assert "tpu_ray_tracer" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "tpu_ray_tracer.render", object())
    assert "tpu_ray_tracer" in harness.forbidden_loaded()
