"""The pipeline route's CUDA graphs on the CPU, through the fake graph of
tests/test_torch_graphs.py (its replay re-runs the body on the static
buffers, so an input that is not copied in shows as a wrong result).

The pipeline-route train step's key (the temperature's value is not in it;
shapes, row blocks, bounces, dtype and pair kinds are), a soft fit under a
temperature schedule through one capture against the eager steps, the soft
render with a tensor temperature against a float one, the plain pipeline
frame and the >31-light gradient (``PipelineGradRender``) graphed against
eager, and the bound on the bytes a cache's graphs keep. The bitwise checks
on the card are in tests/test_torch_gpu.py and chip_smoke.py phase 9f.
"""

import dataclasses

import numpy as np
import pytest
import torch

import tpu_ray_tracer_torch as ttt
from tpu_ray_tracer_torch.diff import inverse
from tpu_ray_tracer_torch.diff.inverse import (InverseProblem, extract_params, make_loss_fn,
                                               make_train_step, param_tensors, tau_schedule)
from tpu_ray_tracer_torch.diff.soft import render_rays_soft
from tpu_ray_tracer_torch.models import light as tlight
from tpu_ray_tracer_torch.models import surface as tsurface
from tpu_ray_tracer_torch.models.scene import Object
from tpu_ray_tracer_torch.ops import camera as camera_ops
from tpu_ray_tracer_torch.render import graphs, kernel_backend as kb, pipeline
from tpu_ray_tracer_torch.utils import launches

from conftest import scene_path
from test_torch_graphs import FakeGraphs, nbytes

SOFT_CONFIG = ttt.RenderConfig("float32", polish_iters=2, bounces=0, chunk_px=None)


def _scene(name, width=16, height=12):
    return dataclasses.replace(ttt.load_from_file(scene_path(name), device="cpu"),
                               width=width, height=height)


def _camera(yaw=90.0, pitch=0.0):
    return ttt.Camera(position=torch.zeros(3, dtype=torch.float32),
                      yaw_deg=torch.tensor(yaw, dtype=torch.float32),
                      pitch_deg=torch.tensor(pitch, dtype=torch.float32))


class GraphFake(FakeGraphs):
    """The fake of tests/test_torch_graphs.py for graphs that carry autograd
    state. Its capture leaves the tensors of ``keep()`` as it found them (a
    real capture executes nothing, so it takes no optimizer step), and its
    replay re-runs the body with grad mode on and swaps a re-run output that
    carries an autograd graph into the static one, so that a backward graph
    captured into the forward's pool re-runs on the fresh forward (a real
    replay rewrites the saved tensors in place)."""

    def __init__(self, keep=list):
        super().__init__()
        self.keep = keep

    def capture(self, device, fn, pool=None):
        saved = [t.detach().clone() for t in self.keep()]
        out = super().capture(device, fn, pool)
        with torch.no_grad():
            for t, value in zip(self.keep(), saved):
                t.copy_(value)
        return out

    def replay(self, graph):
        self.calls.append("replay")
        fn, out = graph
        before = graphs.launch_counts()
        with graphs.eager(), torch.enable_grad():
            new = fn()
        launches.restore(before)
        for static, value in zip(graphs._tensors(out), graphs._tensors(new)):
            with torch.no_grad():
                static.copy_(value)
            if value.requires_grad:  # the static storage, the fresh autograd graph
                value.data = static.data
                torch.utils.swap_tensors(static, value)


@pytest.fixture
def graphed(monkeypatch):
    """Graphs on for CPU tables (outside ``graphs.eager()``), through a
    ``GraphFake``, with new frame caches for the test's duration."""
    backend = GraphFake()
    monkeypatch.setattr(graphs, "BACKEND", backend)
    monkeypatch.setattr(graphs, "active", lambda device: not graphs._STATE.__dict__.get(
        "eager", False))
    monkeypatch.setattr(pipeline, "_FRAMES", graphs.GraphCache())
    monkeypatch.setattr(kb, "_FRAMES", graphs.GraphCache())
    return backend


def _soft_problem(scene, soft_tau=0.15, config=SOFT_CONFIG):
    with torch.no_grad(), graphs.eager():
        target = ttt.render_image(scene, _camera(), config)
    perturbed = dataclasses.replace(scene, light_color=scene.light_color * 0.6,
                                    coefs=scene.coefs * 0.97)
    return InverseProblem(scene_template=perturbed, config=config,
                          param_fields=("coefs", "light_color"), learning_rate=5e-2,
                          backend="torch", soft_tau=soft_tau), target


def _momentum(params):
    """SGD with momentum (its state is made at the first step, as Adam's),
    flagged capturable: a capturable Adam needs a CUDA device."""
    optimizer = torch.optim.SGD(param_tensors(params), lr=0.5, momentum=0.9)
    optimizer.param_groups[0]["capturable"] = True
    return optimizer


def test_pipeline_step_key_ignores_tau(monkeypatch):
    """The pipeline-route step's key: the temperature's value leaves it as
    it is; the inputs' shapes, the row blocks, the bounces, the dtype and
    the pair kinds change it. No slot statics are derived from the
    coefficients: an edit that would reorder the kernel's slots keeps it."""
    problem, target = _soft_problem(_scene("clebsch"))
    loss_fn = make_loss_fn(problem)
    params = extract_params(problem.scene_template, problem.param_fields)
    optimizer = _momentum(params)
    cam = _camera()
    fixed = [cam.position, cam.yaw_deg, cam.pitch_deg]

    def key(loss=loss_fn, tau=0.15, shape_of=target, p=params):
        inputs = [shape_of, *fixed, inverse._tau_tensor(tau, "cpu")]
        return inverse._step_key(loss, p, optimizer, inputs)

    base = key()
    assert key(tau=1e-3) == key(tau=torch.tensor(0.05)) == base
    assert base[0][0] == "pipeline"
    assert key(shape_of=target[:-1]) != base
    with torch.no_grad():
        params["coefs"][0, 0] += 0.5  # clebsch's cubic term moves: no re-key
    assert key() == base
    f64 = make_loss_fn(dataclasses.replace(problem, config=dataclasses.replace(
        SOFT_CONFIG, geom_dtype="float64")))
    assert key(loss=f64, p=extract_params(problem.scene_template.astype(torch.float64),
                                          problem.param_fields)) != base
    for field, value in (("block_rows", loss_fn.block_rows - 1), ("bounces", 1),
                         ("pair_kinds", tuple(not k for k in loss_fn.pair_kinds))):
        monkeypatch.setattr(loss_fn, field, value)
        assert key() != base, field
        monkeypatch.undo()
    assert key() == base


def test_soft_fit_under_tau_schedule_one_capture(graphed):
    """A 4-step soft fit annealed by ``tau_schedule`` through the fake: the
    first step warms up, the second captures, and every step replays the
    one graph with its own temperature copied in; the losses and the
    parameters equal 4 eager steps bit for bit."""
    problem, target = _soft_problem(_scene("clebsch"))
    taus = tau_schedule(0.15, 0.05, 4)

    def run(eager):
        params = extract_params(problem.scene_template.astype(torch.float32),
                                problem.param_fields)
        optimizer = _momentum(params)
        graphed.keep = lambda: param_tensors(params) + [
            v for t in param_tensors(params) for v in optimizer.state[t].values()]
        step = make_train_step(problem)
        with graphs.eager() if eager else torch.enable_grad():
            losses = [step(params, optimizer, _camera(), target, tau) for tau in taus]
        return losses, params, step

    want, want_params, _ = run(eager=True)
    assert graphed.calls == []
    losses, params, step = run(eager=False)
    assert graphed.calls == ["warmup", "capture", "replay", "replay", "replay"]
    assert step.graphs.captures == 1 and len(step.graphs) == 1 and step.graphs.over_bound == 0
    assert losses == want and len(set(losses)) == 4
    for name in params:
        assert torch.equal(params[name], want_params[name]), name


def test_soft_render_tau_tensor_equals_float():
    """``render_rays_soft`` with the temperature as a 0-d f32 tensor gives
    the bits of the same temperature as a float, and a device mask of the
    pair kinds the bits of the tuple."""
    scene = _scene("clebsch", 24, 16).astype(torch.float32)
    rotation, eye = camera_ops.camera_frame(_camera(pitch=3.0))
    dirs = camera_ops.pixel_directions(rotation, scene.width, scene.height,
                                       scene.aspect_ratio, scene.tan_half_fov)
    origin = eye.expand(dirs.shape)
    kinds = tuple((scene.coefs[:, :10].abs() > 0).any(1).tolist())
    for tau in (0.15, 0.0371, 1e-4):
        ref = render_rays_soft(scene, origin, dirs, polish_iters=2, tau=tau, pair_kinds=kinds)
        got = render_rays_soft(scene, origin, dirs, polish_iters=2,
                               tau=torch.tensor(tau, dtype=torch.float32),
                               pair_kinds=torch.tensor(kinds))
        assert torch.equal(got, ref), tau


def test_pipeline_frame_through_a_fake_graph(graphed):
    """``render_image`` on CPU tables through the fake: warm-up, capture and
    replay, replay; each frame equals the eager one bit for bit at its own
    pose (FAST and GOLDEN in chunks), a kept frame does not change, and a
    frame with a gradient stays eager."""
    scene = _scene("reflection_test", 16, 12)
    poses = [_camera(), _camera(92.0, 3.0), _camera(87.0, -2.0)]
    for config in (ttt.FAST_CONFIG, dataclasses.replace(ttt.GOLDEN_CONFIG, chunk_px=50)):
        calls = len(graphed.calls)
        frames = [ttt.render_image(scene, cam, config) for cam in poses]
        kept = [f.clone() for f in frames]
        assert graphed.calls[calls:] == ["warmup", "capture", "replay", "replay"]
        for cam, frame, copy in zip(poses, frames, kept):
            assert torch.equal(frame, copy)
            with graphs.eager():
                assert torch.equal(frame, ttt.render_image(scene, cam, config))
    assert pipeline._FRAMES.captures == 2 and pipeline._FRAMES.over_bound == 0
    leaf = scene.light_color.clone().requires_grad_()
    calls = len(graphed.calls)
    ttt.render_image(dataclasses.replace(scene, light_color=leaf), poses[0]).sum().backward()
    assert graphed.calls[calls:] == [] and leaf.grad is not None


def _many_lights(n_lights=33, width=16, height=12):
    objects = [Object(tsurface.sphere((0.0, 0.0, 6.0), 2.0), 0.0, np.float32([0.8, 0.3, 0.2])),
               Object(tsurface.plane((0.0, -3.0, 0.0), (0.0, 1.0, 0.0)), 0.0,
                      np.float32([0.2, 0.6, 0.9]))]
    lights = [tlight.directional(0.08, (np.cos(2 * np.pi * i / n_lights) * 0.5, -1.0,
                                        np.sin(2 * np.pi * i / n_lights) * 0.5 + 0.3),
                                 (1.0, 0.5 + 0.25 * (i % 3), 0.5 + 0.5 * (i % 2)))
              for i in range(n_lights)]
    return ttt.build_scene(width, height, 60.0, objects, lights, bg_color=(0.1, 0.1, 0.1),
                           device="cpu")


@pytest.mark.parametrize("case", ["33_lights", "no_objects"])
def test_pipeline_grad_render_through_a_fake_graph(graphed, case):
    """The gradient of a scene the fused backward cannot encode, through
    the fake: the forward (one K1 frame, the plain version here) and the
    backward (the pipeline's recompute) warm up, then capture and replay;
    every frame and gradient equals the eager one bit for bit. (The launch
    counts are checked on the card: the CPU runs the plain version.)"""
    scene = _many_lights()
    fields = ("light_color", "coefs", "bg_color")
    if case == "no_objects":
        scene = ttt.build_scene(16, 12, 60.0, [], [tlight.directional(
            1.0, (0.0, -1.0, 0.0), (1.0, 1.0, 1.0))], bg_color=(0.3, 0.6, 0.9), device="cpu")
        fields = ("light_color", "bg_color")
    weights = torch.linspace(0.1, 1.0, scene.height * scene.width * 3).reshape(
        scene.height, scene.width, 3)

    def grads(cam, eager=False):
        leaves = {f: getattr(scene, f).detach().clone().requires_grad_() for f in fields}
        with graphs.eager() if eager else torch.enable_grad():
            image = ttt.render_image_kernel(dataclasses.replace(scene, **leaves), cam)
            (weights * image).sum().backward()
        return image.detach(), {f: leaf.grad for f, leaf in leaves.items()}

    for k in range(3):
        cam = _camera(90.0 + 0.7 * k, 4.0)
        image, got = grads(cam)
        want_image, want = grads(cam, eager=True)
        assert torch.equal(image, want_image), k
        for f in fields:
            assert got[f] is not None and torch.equal(got[f], want[f]), (k, f)
    assert graphed.calls == ["warmup", "capture", "capture", "replay", "replay", "replay",
                             "replay"]
    assert kb._FRAMES.captures == 1


def test_a_backward_after_a_later_forward_replays_its_own(graphed):
    """A differentiable graph's pool holds one forward's saved tensors: the
    backward of a frame whose forward a later frame replaced replays that
    forward again first, and gives the eager gradient bit for bit, unless
    an input was modified in place in between, which raises."""
    scene = _many_lights()
    leaf = scene.light_color.detach().clone().requires_grad_()
    grad_scene = dataclasses.replace(scene, light_color=leaf)
    cams = [_camera(90.0 + 0.7 * k, 4.0) for k in range(4)]
    for cam in cams[:2]:  # the warm-up, then the capture
        ttt.render_image_kernel(grad_scene, cam).sum().backward()
    first = ttt.render_image_kernel(grad_scene, cams[2])
    ttt.render_image_kernel(grad_scene, cams[3])
    leaf.grad = None
    first.sum().backward()
    got = leaf.grad
    with graphs.eager():
        want = torch.autograd.grad(ttt.render_image_kernel(grad_scene, cams[2]).sum(), leaf)[0]
    assert torch.equal(got, want)
    first = ttt.render_image_kernel(grad_scene, cams[2])
    ttt.render_image_kernel(grad_scene, cams[3])
    with torch.no_grad():
        leaf.mul_(1.0)
    with pytest.raises(RuntimeError, match="modified in place between the call's forward and "
                                           "its backward"):
        first.sum().backward()
    assert kb._FRAMES.captures == 1


def test_byte_bound_runs_a_large_key_eagerly(graphed, monkeypatch):
    """With ``MAX_GRAPH_BYTES`` below a frame's warm-up bytes the key is
    never captured: its later calls run eagerly, on the current stream, and
    ``over_bound`` counts them. Under the bound, a capture first drops the
    least recently used graphs until its bytes fit."""
    scene = _scene("dingdong", 16, 12)
    frame_bytes = scene.height * scene.width * 3 * 4
    monkeypatch.setattr(graphs, "MAX_GRAPH_BYTES", frame_bytes - 1)
    frames = [ttt.render_image(scene, _camera(90.0 + k)) for k in range(3)]
    assert graphed.calls == ["warmup"]
    assert pipeline._FRAMES.over_bound == 2 and pipeline._FRAMES.captures == 0
    with graphs.eager():
        assert all(torch.equal(f, ttt.render_image(scene, _camera(90.0 + k)))
                   for k, f in enumerate(frames))

    monkeypatch.setattr(graphs, "MAX_GRAPH_BYTES", 2 * frame_bytes)
    cache = graphs.GraphCache()
    device = torch.device("cpu")

    def call(key, rows):
        x = torch.ones(rows, scene.width, 3)
        return cache.run(key, device, lambda: graphs.Graph(device, lambda t: t * 2, [x]),
                         lambda: x * 2, [x])

    for key, rows in (("a", 12), ("b", 12), ("a", 12), ("b", 12), ("c", 6), ("c", 6)):
        call(key, rows)
    assert cache.bytes("a") == cache.bytes("b") == frame_bytes
    assert cache.bytes("c") == frame_bytes // 2
    # "c" needed room: "a", the least recently used graph, was dropped
    assert [g.inputs[0].shape[0] for g in cache.graphs()] == [12, 6]
    assert cache.bytes() == frame_bytes + frame_bytes // 2 == nbytes(
        [g.forward.outputs for g in cache.graphs()])
    assert cache.over_bound == 0
