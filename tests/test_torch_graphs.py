"""The CUDA-graph layer of the port (``tpu_ray_tracer_torch/render/graphs.py``)
on the CPU, where no graph is captured.

The frame graph's key against the values and statics a call carries; the
CPU path, which captures nothing and returns what the eager body returns;
the launch accounting and the fresh outputs, with a fake graph injected in
place of ``torch.cuda.CUDAGraph``; the graphed forward entry driven end to
end on CPU tables through that fake; and the fit step's warm-ups. The fit
step's eager path on the kernel route against the JAX package's
``make_train_step`` is in tests/test_torch_inverse.py, and the bitwise
graphed-against-eager checks on the card are in tests/test_torch_gpu.py.
"""

import contextlib
import dataclasses

import pytest
import torch

import tpu_ray_tracer_torch as ttt
from tpu_ray_tracer_torch.diff.inverse import (InverseProblem, extract_params, make_train_step,
                                               param_tensors)
from tpu_ray_tracer_torch.models.surface import COEF_INDEX
from tpu_ray_tracer_torch.render import graphs, kernel_backend as kb, pipeline
from tpu_ray_tracer_torch.render.bwd_kernel import render_bwd
from tpu_ray_tracer_torch.render.fwd_kernel import render_fwd, render_fwd_plain
from tpu_ray_tracer_torch.utils import launches

from conftest import scene_path


def _scene(name="dingdong", width=16, height=12):
    return dataclasses.replace(ttt.load_from_file(scene_path(name), device="cpu"),
                               width=width, height=height)


def _camera(yaw=90.0, pitch=0.0, position=(0.0, 0.0, 0.0)):
    return ttt.Camera(position=torch.tensor(position, dtype=torch.float32),
                      yaw_deg=torch.tensor(yaw, dtype=torch.float32),
                      pitch_deg=torch.tensor(pitch, dtype=torch.float32))


def _key(scene, camera, row0=0, rows=None, bounces=0, wants_grad=False):
    rows = scene.height if rows is None else rows
    return kb._frame_key(scene, camera, row0, rows, 3, bounces, 1, wants_grad)


class FakeGraphs:
    """``graphs.CudaGraphs`` on the CPU: a capture runs the function once and
    keeps it, and a replay runs it again into the captured outputs and takes
    back what its wrappers counted, since a real replay runs no Python. The
    bytes of a warm-up and of a capture are those of the tensors the
    function returned (``nbytes``)."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def grown(device, fn):
        out = fn()
        return out, nbytes(out)

    def warmup(self, device, fn):
        self.calls.append("warmup")
        return fn()

    def capture(self, device, fn, pool=None):
        self.calls.append("capture")
        out = fn()
        return (fn, out), out, nbytes(out)

    @staticmethod
    def pool(graph):
        return None

    def replay(self, graph):
        self.calls.append("replay")
        fn, out = graph
        before = graphs.launch_counts()
        with graphs.eager():  # as at the capture
            new = fn()
        launches.restore(before)
        for static, value in zip(graphs._tensors(out), graphs._tensors(new)):
            static.copy_(value)


def nbytes(out) -> int:
    return sum(t.numel() * t.element_size() for t in graphs._tensors(out))


@pytest.fixture
def fake(monkeypatch):
    backend = FakeGraphs()
    monkeypatch.setattr(graphs, "BACKEND", backend)
    return backend


def test_frame_key_follows_statics_not_values():
    """Camera values leave the key as it is; a coefficient edit that moves
    an object into the cubics or flips a quadric's posdef changes it, and so
    do the bounce count, rows and row0."""
    scene, cam = _scene(), _camera()
    key = _key(scene, cam)
    assert _key(scene, _camera(yaw=91.5, pitch=-3.0, position=(0.1, 0.2, -0.3))) == key
    colors = dataclasses.replace(scene, colors=scene.colors * 0.5,
                                 light_color=scene.light_color * 0.7)
    assert _key(colors, cam) == key
    # a sphere gains an x^3 term: it joins the cubics
    coefs = scene.coefs.clone()
    coefs[2, 0] = 0.5
    assert kb._statics_for(coefs)[1] != kb._statics_for(scene.coefs)[1]
    assert _key(dataclasses.replace(scene, coefs=coefs), cam) != key
    # a sphere's x^2 term turns negative: its quadratic form is no longer
    # positive definite, the partition is unchanged
    coefs = scene.coefs.clone()
    coefs[2, COEF_INDEX["x2"]] = -1.0
    edited = kb._statics_for(coefs)
    assert edited[:2] == kb._statics_for(scene.coefs)[:2] and edited[2] != kb._statics_for(
        scene.coefs)[2]
    assert _key(dataclasses.replace(scene, coefs=coefs), cam) != key
    assert _key(scene, cam, bounces=2) != key
    assert _key(scene, cam, rows=scene.height - 1) != key
    assert _key(scene, cam, row0=1, rows=scene.height - 1) != _key(scene, cam,
                                                                  rows=scene.height - 1)
    assert _key(scene, cam, wants_grad=True) != key
    grad_scene = dataclasses.replace(scene, colors=scene.colors.clone().requires_grad_())
    assert _key(grad_scene, cam) == key  # a forward frame ignores requires_grad
    assert _key(grad_scene, cam, wants_grad=True) != _key(scene, cam, wants_grad=True)


def test_cpu_tables_never_capture(monkeypatch):
    """On CPU tables no graph is touched, and the entry points return, bit
    for bit, the eager body's frame and the parent's: ``pack_frame`` then
    the plain forward, forward and gradient alike."""

    class Refuse:
        def __getattr__(self, name):
            raise AssertionError(f"the CPU path called the graph backend's {name}")

    monkeypatch.setattr(graphs, "BACKEND", Refuse())
    kb._FRAMES.clear()
    scene, cam = _scene("reflection_test", 16, 12), _camera(pitch=4.0)
    for _ in range(3):
        image = ttt.render_image_kernel(scene, cam)
        rows = kb.render_rows_kernel(scene, cam, 3, 5)
    tables, kw = kb.pack_frame(scene, cam, 0, scene.height)
    assert torch.equal(image, render_fwd_plain(*tables, **kw))
    assert torch.equal(image, kb._render_rows_eager(scene, cam, 0, scene.height))
    assert torch.equal(rows, kb._render_rows_eager(scene, cam, 3, 5))
    leaf = scene.colors.clone().requires_grad_()
    kb.render_image_kernel(dataclasses.replace(scene, colors=leaf), cam).sum().backward()
    grad = leaf.grad.clone()
    leaf.grad = None
    tables, kw = kb.pack_frame(dataclasses.replace(scene, colors=leaf), cam, 0, scene.height)
    kb.PackedRender.apply(*tables, kw).sum().backward()
    assert torch.equal(grad, leaf.grad)
    assert len(kb._FRAMES._entries) == 0 and kb._FRAMES.captures == 0


def _bump_counts():
    render_fwd.launches += 1
    render_fwd.launches_by_variant["main"] += 1
    render_bwd.launches += 2
    render_bwd.launches_by_placement["warp.shared"] += 2


def test_capture_takes_back_counts_and_replay_adds_them(fake):
    """A capture leaves every counter as it was and records what the
    wrappers counted; each replay adds the recorded counts; the warm-up,
    which executes, counts as it runs."""
    cache = graphs.GraphCache()
    x = torch.arange(4.0)

    def body(t):
        _bump_counts()
        return t * 2

    def call(t):
        entry = cache.lookup("k", lambda: graphs.Graph(torch.device("cpu"), body, [t]))
        return graphs.warmup(x.device, lambda: body(t)) if entry is None else entry([t])

    start = graphs.launch_counts()
    call(x)  # first use: the warm-up
    after_warmup = graphs.launch_counts()
    assert after_warmup["render_fwd"] == start["render_fwd"] + 1
    assert fake.calls == ["warmup"]
    entry = graphs.Graph(torch.device("cpu"), body, [x])
    assert graphs.launch_counts() == after_warmup  # the capture took its counts back
    assert entry.forward.counts == {"render_fwd": 1, "render_fwd.main": 1, "render_bwd": 2,
                                     "render_bwd.warp.shared": 2}
    out = call(x + 1)  # second use: capture, then replay
    assert fake.calls == ["warmup", "capture", "capture", "replay"]
    assert torch.equal(out, (x + 1) * 2) and cache.captures == 1
    counts = graphs.launch_counts()
    assert counts["render_fwd"] == after_warmup["render_fwd"] + 1
    assert counts["render_bwd.warp.shared"] == after_warmup["render_bwd.warp.shared"] + 2
    call(x + 2)
    assert graphs.launch_counts()["render_bwd"] == counts["render_bwd"] + 2
    assert cache.captures == 1 and len(cache) == 1


def test_a_registered_counter_is_taken_back_and_replayed(fake, monkeypatch):
    """A launch counter that a wrapper registers (``utils/launches.py``),
    which ``render/graphs.py`` does not name, a plain counter and a
    breakdown dict: the capture takes its increments back and records
    them, and each replay adds them."""
    monkeypatch.setattr(launches, "_WHERE", dict(launches._WHERE))

    def wrapper(t):
        wrapper.launches += 1
        wrapper.launches_by_kind["a"] += 2
        return t + 1

    wrapper.launches, wrapper.launches_by_kind = 0, {"a": 0, "b": 0}
    launches.register("probe", wrapper, "launches")
    launches.register("probe", wrapper, "launches_by_kind")
    graph = graphs.Graph(torch.device("cpu"), wrapper, [torch.zeros(2)])
    assert graph.forward.counts == {"probe": 1, "probe.a": 2}
    assert wrapper.launches == 0 and wrapper.launches_by_kind == {"a": 0, "b": 0}
    for k in (1, 2):
        assert torch.equal(graph([torch.full((2,), float(k))]), torch.full((2,), k + 1.0))
        counts = graphs.launch_counts()
        assert (counts["probe"], counts["probe.a"], counts["probe.b"]) == (k, 2 * k, 0)
        assert wrapper.launches == k and wrapper.launches_by_kind == {"a": 2 * k, "b": 0}


# The per-tensor half of each caller's key as each built it before
# ``graphs.signature``: the frame's, the pipeline frame's and the step's
PARENT_SIGNATURE = {
    "frame": lambda ts, grad: tuple((tuple(t.shape), t.dtype, t.device,
                                     grad and t.requires_grad) for t in ts),
    "pipeline": lambda ts, grad: tuple((tuple(t.shape), t.dtype, t.device) for t in ts),
    "step": lambda ts, grad: tuple((tuple(t.shape), t.dtype) for t in ts),
}


@pytest.mark.parametrize("caller", sorted(PARENT_SIGNATURE))
def test_signature_keeps_which_calls_share_a_graph(caller):
    """``graphs.signature`` against each key builder's own per-tensor key
    before it, on the builder's tensors: other values, another shape,
    another dtype and a tensor that requires grad. Two calls share a graph
    under the one exactly where they did under the other (the frame's
    forward and differentiable keys alike)."""
    scene, cam = _scene(), _camera()
    if caller == "frame":
        tensors = kb._frame_tensors(scene, cam)
    elif caller == "pipeline":
        tensors = pipeline._frame_tensors(scene, cam)
    else:
        params = extract_params(scene, ("coefs", "light_color"))
        tensors = [torch.zeros(scene.height, scene.width, 3), cam.position, cam.yaw_deg,
                   cam.pitch_deg, torch.tensor(0.15, dtype=torch.float64),
                   *param_tensors(params)]
    i = next(i for i, t in enumerate(tensors) if t.dim() > 0 and t.is_floating_point())
    variants = [tensors, [t.detach().clone() + (t.is_floating_point()) for t in tensors]]
    for edit in (lambda t: t[:-1], lambda t: t.double(),
                 lambda t: t.detach().clone().requires_grad_()):
        variants.append(tensors[:i] + [edit(tensors[i])] + tensors[i + 1:])
    for grad in ((False, True) if caller == "frame" else (False,)):
        old = [PARENT_SIGNATURE[caller](ts, grad) for ts in variants]
        new = [graphs.signature(ts, grad) for ts in variants]
        for a in range(len(variants)):
            for b in range(len(variants)):
                assert (old[a] == old[b]) == (new[a] == new[b]), (grad, a, b)


def test_outputs_are_fresh_and_cache_is_bounded(fake, monkeypatch):
    """A returned tensor is not the graph's output: the next replay leaves
    it unchanged. The cache keeps at most ``graphs.MAX_GRAPHS`` keys,
    dropping the least recently used."""
    graph = graphs.Graph(torch.device("cpu"), lambda t: (t + 1, t * 3), [torch.zeros(3)])
    first = graph([torch.ones(3)])
    kept = [t.clone() for t in first]
    second = graph([torch.full((3,), 5.0)])
    assert all(torch.equal(a, b) for a, b in zip(first, kept))
    assert torch.equal(second[0], torch.full((3,), 6.0))
    assert first[0].data_ptr() != graph.forward.outputs[0].data_ptr()
    monkeypatch.setattr(graphs, "MAX_GRAPHS", 2)
    cache = graphs.GraphCache()
    made = []
    for key in ("a", "b", "a", "c", "a", "b"):
        cache.lookup(key, lambda key=key: made.append(key) or key)
    # "b" was dropped when "c" arrived, so its second use is a first use again
    assert made == ["a"] and len(cache) == 1
    assert cache.lookup("b", lambda: "b2") == "b2"


def test_capture_holds_memoised_tables(fake):
    """A capture that reads the memoised slot tables holds them: the memo
    may drop them while the graph still reads them at their addresses."""
    scene = _scene()
    graph = graphs.Graph(torch.device("cpu"),
                         lambda: kb.pack_frame(scene, _camera(), 0, scene.height)[0][0], [])
    slots = kb._slot_tables(scene.coefs)
    assert any(h is slots for h in graph.forward.held)
    kb._MEMO.clear()
    assert any(all(a is b for a, b in zip(h, slots)) for h in graph.forward.held
               if isinstance(h, tuple))
    assert graphs.hold("x") == "x"  # outside a capture nothing is held


def test_graphed_forward_entry_through_a_fake_graph(fake, monkeypatch):
    """The graphed forward path end to end on CPU tables, a fake graph in
    place of the card's: the first call warms up, the second captures and
    replays, and every frame equals the eager body's bit for bit at its own
    pose; a kept frame does not change when the next one renders."""
    monkeypatch.setattr(graphs, "active", lambda device: not graphs._STATE.__dict__.get(
        "eager", False))
    kb._FRAMES.clear()
    scene = _scene("dingdong", 16, 12)
    poses = [_camera(), _camera(yaw=92.0, pitch=3.0), _camera(yaw=87.0, position=(0, 0.5, 0))]
    frames = [kb.render_image_kernel(scene, cam) for cam in poses]
    kept = [f.clone() for f in frames]
    assert fake.calls == ["warmup", "capture", "replay", "replay"]
    assert kb._FRAMES.captures == 1
    for cam, image, copy in zip(poses, frames, kept):
        assert torch.equal(image, copy)
        with graphs.eager():
            assert torch.equal(image, kb.render_image_kernel(scene, cam))
    assert fake.calls[-1] == "replay"  # inside eager() no graph was used
    kb._FRAMES.clear()


def test_fit_step_without_optimizer_state_warms_up(fake, monkeypatch):
    """A step whose parameters have no optimizer state yet runs as a
    warm-up, even under a key whose graph exists: a capture would record
    the optimizer's creation of that state and replay it at every step. One
    train step, driven with a fake graph by a momentum optimizer (its state
    is made at the first step, as Adam's is) and then by a new one: each
    new optimizer warms up, then captures and replays, then replays. The fake's capture
    runs the step, so only the warm-ups' losses are held against an eager
    step here; tests/test_torch_gpu.py holds every step on the card."""
    scene = _scene("dingdong", 16, 12)
    with torch.no_grad():
        target = ttt.render_image_kernel(scene, _camera(), polish_iters=2, bounces=0)
    monkeypatch.setattr(graphs, "active", lambda device: not graphs._STATE.__dict__.get(
        "eager", False))
    problem = InverseProblem(
        scene_template=dataclasses.replace(scene, light_color=scene.light_color * 0.6),
        param_fields=("light_color",), backend="kernel",
        config=ttt.RenderConfig(geom_dtype="float32", polish_iters=2, bounces=0, chunk_px=None))

    def run(step, eager=False):
        params = extract_params(problem.scene_template, problem.param_fields)
        optimizer = torch.optim.SGD(param_tensors(params), lr=0.5, momentum=0.9)
        optimizer.param_groups[0]["capturable"] = True  # SGD ignores it; the step reads it
        with graphs.eager() if eager else contextlib.nullcontext():
            return [step(params, optimizer, _camera(), target) for _ in range(3)]

    want = run(make_train_step(problem), eager=True)
    assert fake.calls == []
    step = make_train_step(problem)
    first, again = run(step), run(step)
    assert fake.calls == ["warmup", "capture", "replay", "replay"] * 2
    assert first[0] == again[0] == want[0]
    assert step.graphs.captures == 2 and len(step.graphs) == 1
