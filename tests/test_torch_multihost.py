"""Multi-process bookkeeping and the row-sharded fit of the port
(``tpu_ray_tracer_torch/parallel/multihost.py``, ``diff/inverse.py`` ``fit``,
``cli.py fit --distributed``) on the CPU: the semantics of
tests/test_multihost.py and tests/multihost_worker.py against the port.

``_row_span`` is held case by case against the JAX package's. The fit runs in
two real gloo ranks (tests/torch_rank_worker.py, spawned once, a
``FileStore`` under the test's temporary directory) with a checkpoint path
shared by both; ``fit --distributed`` runs in two ranks under
``torch.distributed.run`` with ``--device cpu``. Both are held against one
process's fit within the fused-backward rule.
"""

import contextlib
import dataclasses
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_ray_tracer.parallel.multihost import _row_span as jax_row_span
from tpu_ray_tracer_torch import cli, render_image_kernel
from tpu_ray_tracer_torch.diff import inverse
from tpu_ray_tracer_torch.parallel import multihost
from tpu_ray_tracer_torch.parallel.multihost import _row_span

from test_torch_grad import assert_group_close
from torch_rank_worker import CONFIG, load, pose, spawn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_multihost.py:25-53: (height, device -> process ids, process, span)
ROW_SPANS = [
    ("single_process", 48, [0] * 8, 0, (0, 48)),
    ("two_even_first", 16, [0, 0, 1, 1], 0, (0, 8)),
    ("two_even_second", 16, [0, 0, 1, 1], 1, (8, 8)),
    ("ragged_first", 10, [0, 0, 1, 1], 0, (0, 6)),
    ("ragged_tail", 10, [0, 0, 1, 1], 1, (6, 4)),
    ("past_the_end", 3, [0] * 4 + [1] * 4, 1, (3, 0)),
    ("absent_process", 16, [0, 0], 3, (0, 0)),
]


@pytest.mark.parametrize("height,pids,pid,span", [c[1:] for c in ROW_SPANS],
                         ids=[c[0] for c in ROW_SPANS])
def test_row_span_equals_jax(height, pids, pid, span):
    assert _row_span(height, pids, pid) == jax_row_span(height, pids, pid) == span


def test_row_span_rejects_noncontiguous():
    for fn in (_row_span, jax_row_span):
        with pytest.raises(ValueError, match="not contiguous"):
            fn(16, [0, 1, 0, 1], 0)


def test_one_process_world(monkeypatch):
    """At world size 1 initialize_distributed does nothing; the world is
    this process's device and the whole image."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.initialize_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert multihost.global_pixel_mesh("cpu") == [torch.device("cpu")]
    assert multihost.host_local_rows(21) == (0, 21)


@pytest.fixture(scope="module")
def fit_ranks(tmp_path_factory):
    return spawn("fit", 2, tmp_path_factory.mktemp("fit2"))


def _one_process_fit():
    """The ranks' fit in one process: quadratic 32x16, light colours x0.6,
    the kernel route, 3 steps."""
    scene = load("quadratic", 32, 16)
    with torch.no_grad():
        target = render_image_kernel(scene, pose(), polish_iters=2, bounces=0)
    problem = inverse.InverseProblem(
        dataclasses.replace(scene, light_color=scene.light_color * 0.6), CONFIG,
        ("light_color",), learning_rate=5e-2, backend="kernel")
    return inverse.fit(problem, target, pose(), steps=3, log_every=0)


def test_fit_checkpoint_only_rank0_writes(fit_ranks):
    """A checkpoint path shared by both ranks, every step: rank 0 writes it
    3 times, rank 1 never, and both read a step-3 checkpoint."""
    assert sorted(int(r["ckpt_writes"]) for r in fit_ranks) == [0, 3]
    assert int(fit_ranks[0]["ckpt_writes"]) == 3
    assert all(int(r["ckpt_step"]) == 3 for r in fit_ranks)


def test_fit_replicated_across_ranks(fit_ranks):
    """Every rank returns the same losses and the same parameters, bit for
    bit (the all-reduced gradient is the same on every rank), and the
    world's devices in rank order."""
    a, b = fit_ranks
    np.testing.assert_array_equal(a["losses"], b["losses"])
    np.testing.assert_array_equal(a["light_color"], b["light_color"])
    assert a["devices"].tolist() == b["devices"].tolist() == ["cpu", "cpu"]


def test_host_local_rows_tile_the_image(fit_ranks):
    spans = sorted(tuple(int(x) for x in r["row_span"]) for r in fit_ranks)
    assert spans == [(0, 8), (8, 8)]


def test_fit_two_ranks_equal_one_process(fit_ranks):
    """The losses and the fitted light colours of two gloo ranks equal one
    process's within the fused-backward rule, and the loss falls."""
    params, losses = _one_process_fit()
    got = fit_ranks[0]["losses"]
    assert_group_close("losses", got, np.asarray(losses))
    assert_group_close("light_color", fit_ranks[0]["light_color"],
                       params["light_color"].detach().numpy())
    assert got[-1] < got[0]


_STEP = re.compile(r"^step \d+: loss (\S+)$", re.M)
_SUMMARY = re.compile(r"^loss: (\S+) -> (\S+) over (\d+) steps$", re.M)
FIT_ARGS = ["fit", os.path.join(REPO, "scenes", "cayley.yml"), "--size", "24", "16",
            "--steps", "5", "--device", "cpu", "--params", "light_color"]


def test_cli_fit_distributed_two_gloo_ranks():
    """``fit --distributed`` in two ranks under ``torch.distributed.run``
    (``--device cpu``: gloo): exit 0, the summary printed once (rank 0),
    the loss falling, and the logged losses equal one process's within the
    fused-backward rule."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "tpu_ray_tracer_torch.cli", *FIT_ARGS, "--distributed"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    summaries = _SUMMARY.findall(proc.stdout)
    assert len(summaries) == 1 and int(summaries[0][2]) == 5, proc.stdout
    assert float(summaries[0][1]) < float(summaries[0][0])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(FIT_ARGS) == 0
    one = [float(x) for x in _STEP.findall(buf.getvalue())]
    two = [float(x) for x in _STEP.findall(proc.stdout)]
    assert len(two) == len(one) == 2  # steps 0 and 4 of 5 are logged
    assert_group_close("losses", np.asarray(two), np.asarray(one))
