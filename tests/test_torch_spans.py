"""The port's spans on its host path (``utils.timing.span``) on the CPU,
through the fake graph of tests/test_torch_graphs.py: none is entered while
no profiler runs; under ``torch.profiler`` a graphed frame, a graphed fit
step and the memo record their ``trt.`` spans, each inside its parent, in
the order the work runs."""

import dataclasses

import pytest
import torch

import tpu_ray_tracer_torch as ttt
from tpu_ray_tracer_torch.diff.inverse import (InverseProblem, extract_params, make_train_step,
                                               param_tensors)
from tpu_ray_tracer_torch.render import graphs, kernel_backend as kb

from test_torch_graphs import FakeGraphs, _camera, _scene

FRAME = "trt.frame"
STEP = "trt.step"
KEY = [(FRAME, None), ("trt.frame.key", FRAME)]
REPLAYED = [("trt.graph.load", FRAME), ("trt.graph.replay", FRAME), ("trt.graph.fresh", FRAME)]
STEP_KEY = [(STEP, None), ("trt.step.key", STEP), ("trt.graph.lookup", STEP)]
STEP_REPLAYED = [("trt.graph.load", STEP), ("trt.graph.replay", STEP), ("trt.step.wait", STEP)]

# the spans that a case's calls record, one call after the other: (name,
# the nearest enclosing trt. span or None)
EXPECTED = {
    # a first call derives the statics (memo misses) and warms up; a second
    # captures and replays; a third replays
    "frame": (KEY + [("trt.memo", "trt.frame.key")] * 3
              + [("trt.graph.lookup", FRAME), ("trt.graph.warmup", FRAME)]
              + KEY + [("trt.graph.lookup", FRAME), ("trt.graph.capture", "trt.graph.lookup")]
              + REPLAYED
              + KEY + [("trt.graph.lookup", FRAME)] + REPLAYED),
    "step": (STEP_KEY[:2] + [("trt.memo", "trt.step.key"), ("trt.memo", "trt.memo")]
             + STEP_KEY[2:] + [("trt.graph.warmup", STEP)]
             + STEP_KEY + [("trt.graph.capture", "trt.graph.lookup")] + STEP_REPLAYED
             + STEP_KEY + STEP_REPLAYED),
    # a memo miss derives on the host; a hit derives nothing
    "memo": [("trt.memo", None)],
}


@pytest.fixture
def fake(monkeypatch):
    backend = FakeGraphs()
    monkeypatch.setattr(graphs, "BACKEND", backend)
    monkeypatch.setattr(graphs, "active", lambda device: not graphs._STATE.__dict__.get(
        "eager", False))
    kb._FRAMES.clear()
    kb._MEMO.clear()
    yield backend
    kb._FRAMES.clear()


def _calls(case):
    """The calls of ``case``, made one after the other."""
    scene = _scene("dingdong", 16, 12)
    if case == "frame":
        poses = [_camera(), _camera(yaw=92.0, pitch=3.0), _camera(yaw=87.0)]
        return [lambda cam=cam: kb.render_image_kernel(scene, cam) for cam in poses]
    if case == "memo":
        coefs = scene.coefs.clone()
        return [lambda: kb._statics_for(coefs)] * 2
    with torch.no_grad(), graphs.eager():
        target = kb.render_image_kernel(scene, _camera(), polish_iters=2, bounces=0)
    problem = InverseProblem(
        scene_template=dataclasses.replace(scene, light_color=scene.light_color * 0.6),
        param_fields=("light_color",), backend="kernel",
        config=ttt.RenderConfig(geom_dtype="float32", polish_iters=2, bounces=0, chunk_px=None))
    params = extract_params(problem.scene_template, problem.param_fields)
    optimizer = torch.optim.SGD(param_tensors(params), lr=0.5, momentum=0.9)
    optimizer.param_groups[0]["capturable"] = True  # SGD ignores it; the step reads it
    step = make_train_step(problem)
    kb._MEMO.clear()
    return [lambda: step(params, optimizer, _camera(), target)] * 3


def _recorded(calls) -> list:
    """(name, the nearest enclosing trt. span's name or None) of each trt.
    span that ``calls`` record under a CPU profiler, in order of start. Read
    from the profiler's raw events: its event tree takes seconds to build for
    the ~40,000 operations of three plain frames."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for call in calls:
            call()
    spans = sorted((e.start_ns(), -e.end_ns(), e.name())
                   for e in prof.profiler.kineto_results.events() if e.name().startswith("trt."))
    out, open_spans = [], []
    for start, neg_end, name in spans:
        while open_spans and -open_spans[-1][0] <= start:
            open_spans.pop()
        out.append((name, open_spans[-1][1] if open_spans else None))
        open_spans.append((neg_end, name))
    return out


@pytest.mark.parametrize("case", sorted(EXPECTED))
def test_spans_under_the_profiler(fake, case):
    """Each call records its spans inside their parents, in order: the
    frame's key, the graph's lookup, its input copies, the replay and the
    output clones inside ``trt.frame``; the step's key, lookup, replay and
    wait inside ``trt.step``; a warm-up, then a capture, then a replay."""
    assert _recorded(_calls(case)) == EXPECTED[case]
    if case != "memo":
        assert fake.calls == ["warmup", "capture", "replay", "replay"]


@pytest.mark.parametrize("case", ["frame", "step"])
def test_no_span_without_a_profiler(fake, monkeypatch, case):
    """With no profiler running, a graphed frame and a graphed fit step, each
    warmed up, captured and replayed, open no ``record_function`` range."""
    opened = []
    record_function = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or record_function(name))
    for call in _calls(case):
        call()
    assert fake.calls == ["warmup", "capture", "replay", "replay"]
    assert opened == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _calls("memo")[0]()
    assert opened == ["trt.memo"]  # the counting wrapper is the one the spans call
