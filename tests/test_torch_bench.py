"""The port's bench (``tpu_ray_tracer_torch/bench.py``) against the JAX
package's ``bench.py``, on the CPU.

The JSON line carries ``bench.py``'s metric and every aux key it prints,
with the same values for the same results; the bench's forward frame and
its forward+backward gradients agree with the JAX package's XLA pipeline at
``bench.py``'s settings; ``main`` runs all 12 stages with ``--device cpu``
(the kernels' plain versions) and exits nonzero on a failed stage, a
parity breach, and without a card unless the CPU is asked for.
"""

import dataclasses
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_ray_tracer as trt
from tpu_ray_tracer.diff.inverse import apply_params as jax_apply_params
from tpu_ray_tracer.diff.inverse import extract_params as jax_extract_params
from tpu_ray_tracer.ops import camera as jcamera
from tpu_ray_tracer.ops.poly import poly_gradient as jpoly_gradient
from tpu_ray_tracer.render.pipeline import RenderConfig, _render_image_jit, trace_and_shade
from tpu_ray_tracer_torch import bench
from tpu_ray_tracer_torch.ops.poly import poly_gradient
from tpu_ray_tracer_torch.parity import PARITY_GATES, bad_pixel_fraction
from tpu_ray_tracer_torch.render.fwd_kernel import render_fwd
from tpu_ray_tracer_torch.render.kernel_backend import pack_frame

from conftest import scene_path
from test_pallas import PARITY_MAX_BAD
from test_torch_grad import assert_group_close

REPO = pathlib.Path(__file__).resolve().parent.parent
SCALE = 0.05
SWEEP = 32
POSES = (0, 10, 20, 31)  # of the bench's 32-frame sweep
# the bench's frame (K1's plain version) against the XLA pipeline, whole-frame
# sums: the two solve each root their own way, so one or two knife-edge
# pixels of dingdong differ (measured at most 7.8e-4 relative on these
# frames, 1.7e-7 on reflection_test); about twice that
SUM_RTOL = 2e-3
STAGES = ["dingdong.fwd", "dingdong.fwdbwd", "monkey_saddle.fwd", "monkey_saddle.fwdbwd",
          "reflection_test.fwd", "reflection_test.fwdbwd", "20spheres.fwd",
          "20spheres.fwdbwd", "quadratic.fwd", "cubic.fwd", "clebsch.fwd", "cayley.fwd"]
# the aux keys the port adds to bench.py's, and those whose values name the
# run (the machine, the backend, the clock)
ADDED = {"launches", "versions"}
RUN_KEYS = {"device", "forward_backend", "elapsed_s"}


@pytest.fixture(scope="module")
def jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench", REPO / "bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_scene(name):
    """The bundled scene at the bench's scaled size, as ``bench.py`` loads it."""
    scene = trt.load_from_file(scene_path(name))
    return dataclasses.replace(scene, width=max(8, int(scene.width * SCALE)),
                               height=max(8, int(scene.height * SCALE)))


def jax_cam(k):
    yaws = 90.0 + 1e-3 * jnp.arange(SWEEP, dtype=jnp.float32)
    return trt.Camera(position=jnp.zeros(3, jnp.float32), yaw_deg=yaws[k],
                      pitch_deg=jnp.asarray(0.0, jnp.float32))


def jax_config(bounces):
    return RenderConfig(geom_dtype="float32", polish_iters=3, bounces=bounces, chunk_px=None)


def last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def test_emit_matches_bench_py(jax_bench, capsys):
    """(a) One synthetic set of results through both ``_emit``s: the same
    top-level keys and values, and every aux key of ``bench.py`` with its
    value, apart from the keys that name the run; the port adds only
    ``launches``, ``versions`` and the ``kernel_ms_*`` readings."""
    rng = np.random.default_rng(20261017)
    results = {}
    for name in ("dingdong", "monkey_saddle", "reflection_test", "20spheres",
                 "quadratic", "cubic", "clebsch", "cayley"):
        ms = float(rng.uniform(0.5, 3.0))
        results[name] = {"frame_ms_fwd": ms, "mrays_fwd": float(rng.uniform(100, 900)),
                         "parity_bad_px_fraction": float(rng.uniform(0, 1e-3)),
                         "kernel_ms_fwd": ms / 8}
        if name in ("dingdong", "monkey_saddle", "reflection_test", "20spheres"):
            results[name].update(frame_ms_fwd_bwd=4 * ms,
                                 mrays_fwd_bwd=float(rng.uniform(50, 400)),
                                 kernel_ms_bwd=ms / 20)
    results["cubic"]["failed_stages"] = ["cubic.fwd"]
    pending, skipped = ["clebsch.fwd"], ["cayley.fwd"]

    jax_bench._emit(results, pending, skipped)
    ref = last_json(capsys.readouterr().out)
    run = {"launches": {"render_fwd": 7}, "forward_backend": "plain", "device": "cpu",
           "versions": {"torch": "x"}}
    bench._emit(results, pending, skipped, 12.3, run)
    port = last_json(capsys.readouterr().out)

    assert {k: v for k, v in port.items() if k != "aux"} == {
        k: v for k, v in ref.items() if k != "aux"}
    assert port["metric"] == "mrays_per_s_fwd_dingdong_1280x720" and port["unit"] == "Mrays/s"
    kernel_keys = {k for k in port["aux"] if k.startswith("kernel_ms_")}
    assert kernel_keys == {f"kernel_ms_fwd_{n}" for n in (
        "dingdong", "monkey_saddle", "reflection5b", "20spheres", "quadratic", "cubic",
        "clebsch", "cayley")} | {f"kernel_ms_bwd_{n}" for n in (
            "dingdong", "monkey_saddle", "reflection5b", "20spheres")}
    assert set(port["aux"]) - kernel_keys - ADDED == set(ref["aux"])
    for key, value in ref["aux"].items():
        if key not in RUN_KEYS:
            assert port["aux"][key] == value, key
    assert port["aux"]["failed"] == ["cubic.fwd"] and port["aux"]["launches"] == {
        "render_fwd": 7}
    assert port["aux"]["elapsed_s"] == 12.3 and port["aux"]["device"] == "cpu"


@pytest.mark.parametrize("name", ["dingdong", "reflection_test"])
def test_frames_match_xla_pipeline(name):
    """(b) The bench's frame at 4 poses of its sweep against
    ``_render_image_jit`` at ``bench.py``'s config (reflection_test at its 5
    bounces): each frame within tests/test_pallas.py's PARITY_MAX_BAD, and
    each frame's sum within SUM_RTOL."""
    scene = bench.load_scene(name, SCALE, "cpu").astype(torch.float32)
    cams = bench.sweep_cameras(SWEEP, "cpu")
    jscene = jax_scene(name)
    bounces = jscene.max_reflections if name == "reflection_test" else 0
    assert bounces == (5 if name == "reflection_test" else 0)
    scene32 = jax.tree.map(jnp.asarray, jscene.astype(jnp.float32))
    for k in POSES:
        with torch.no_grad():
            port = bench.frame(scene, cams[k], bounces).numpy()
        ref = np.asarray(_render_image_jit(scene32, jax_cam(k), jax_config(bounces)))
        assert port.shape == ref.shape == (scene.height, scene.width, 3)
        frac = bad_pixel_fraction(port, ref)
        assert frac <= PARITY_MAX_BAD[name], (k, frac)
        rel = abs(float(port.sum(dtype=np.float64)) - float(ref.sum(dtype=np.float64)))
        assert rel / float(ref.sum(dtype=np.float64)) < SUM_RTOL, k


@jax.jit
def jax_primary(scene, yaw):
    """The XLA pipeline's primary hit at a pose of the sweep: object (-1 for
    a miss), t, and the slope dF/dt = grad F . d that the implicit-function
    backward divides by."""
    cam = trt.Camera(position=jnp.zeros(3, jnp.float32), yaw_deg=yaw,
                     pitch_deg=jnp.asarray(0.0, jnp.float32))
    rotation, eye = jcamera.camera_frame(cam)
    dirs = jcamera.pixel_directions(rotation, scene.width, scene.height, scene.aspect_ratio,
                                    scene.tan_half_fov)
    res = trace_and_shade(scene, jnp.broadcast_to(eye, dirs.shape), dirs, 3)
    idx = jnp.where(res.hit, res.idx, -1)
    slope = jnp.sum(jpoly_gradient(scene.coefs[jnp.maximum(idx, 0)], res.point) * dirs, -1)
    return idx, jnp.sum((res.point - eye) * dirs, -1), slope, dirs, eye


def hit_alike(scene, template, camera, k):
    """[H, W] bool: the pixels whose primary hit the bench's forward (K1's
    plain version) and the XLA pipeline find alike: the same object, and t
    and dF/dt within 1e-4 relative (``chip_smoke.py`` 8d's criterion)."""
    idx, t, slope, dirs, eye = (np.asarray(a) for a in jax_primary(template, jax_cam(k).yaw_deg))
    tables, kw = pack_frame(scene, camera, 0, scene.height, polish_iters=3, bounces=0)
    _, k_t, k_slot, _ = render_fwd(*tables, **kw, save_aux=True)
    k_t, k_slot = k_t[0].numpy(), k_slot[0].numpy()
    k_idx = np.where(k_slot >= 0, tables[1].numpy()[np.maximum(k_slot, 0)], -1)
    sel = scene.coefs[torch.from_numpy(np.maximum(idx, 0)).long()]
    point = torch.from_numpy((eye + k_t[..., None] * dirs).astype(np.float32))
    k_slope = (poly_gradient(sel, point).numpy() * dirs).sum(-1)
    return (idx == k_idx) & ((idx < 0) | ((np.abs(t - k_t) <= 1e-4 * np.abs(k_t))
                                          & (np.abs(slope - k_slope) <= 1e-4 * np.abs(k_slope))))


def test_fwdbwd_gradients_match_jax_grad():
    """(c) The bench's forward+backward step on dingdong (gradients of
    mean(img^2) with respect to the coefficients and light colours) at two
    poses of its sweep against ``jax.grad`` of ``bench.py``'s loss through
    ``_render_image_jit``, under tests/test_pallas.py:174-181's rule: the
    light colours over the whole frame, and both groups over the pixels
    whose primary hit the two forwards find alike (the loss weighted by that
    mask on both sides).

    Over the whole frame the coefficients' group is outside the rule
    (measured 4.2e-3 and 2.5e-2 at these poses, up to 0.89 at pose 20): on
    ~35 of the 2304 pixels, near the double roots of dingdong's cubic, the
    two forwards' f32 roots differ and the implicit-function backward
    divides by a dF/dt near 0, so one pixel can carry most of the group's
    largest entry (50 to 476 over the frame, against ~10.7 over the rest).
    It is the f32 conditioning that ROADMAP Queue 3 attributes to the
    reference itself (the JAX pipeline's own coefficient gradient moves by
    1.6e-2 under a one-ulp yaw change at pose 10). Over the other pixels the
    two agree to ~1e-5."""
    scene = bench.load_scene("dingdong", SCALE, "cpu").astype(torch.float32)
    params = bench.extract_params(scene)
    cams = bench.sweep_cameras(SWEEP, "cpu")
    template = jax.tree.map(jnp.asarray, jax_scene("dingdong").astype(jnp.float32))
    jparams = jax_extract_params(template)
    assert set(jparams) == set(params) == {"coefs", "light_color"}

    def loss_fn(p, k, weight):
        img = _render_image_jit(jax_apply_params(template, p), jax_cam(k), jax_config(0))
        return jnp.mean(weight[..., None] * img * img)

    grad_fn = jax.jit(jax.grad(loss_fn))
    ones = jnp.ones((scene.height, scene.width), jnp.float32)
    for k in (0, 31):
        port = bench.frame_grads(scene, params, cams[k], 0)
        ref = grad_fn(jparams, k, ones)
        assert all(params[f].grad is None for f in params)
        assert np.isfinite(port["coefs"].numpy()).all()
        assert_group_close(f"light_color at pose {k}", port["light_color"].numpy(),
                           np.asarray(ref["light_color"]))

        alike = hit_alike(scene, template, cams[k], k)
        assert alike.mean() > 0.95, alike.mean()
        weight = torch.from_numpy(alike.astype(np.float32))
        with torch.enable_grad():
            img = bench.frame(bench.apply_params(scene, params), cams[k], 0)
            grads = torch.autograd.grad((weight[..., None] * img * img).mean(),
                                        list(params.values()))
        ref = grad_fn(jparams, k, jnp.asarray(alike, jnp.float32))
        for field, g in zip(params, grads):
            assert np.abs(np.asarray(ref[field])).max() > 0, field
            assert_group_close(f"{field} at pose {k}, alike pixels", g.numpy(),
                               np.asarray(ref[field]))


def run_main(monkeypatch, capsys, scale, frames, budget=None):
    monkeypatch.setenv("TRT_BENCH_SCALE", str(scale))
    monkeypatch.setenv("TRT_BENCH_FRAMES", str(frames))
    if budget is not None:
        monkeypatch.setenv("TRT_BENCH_BUDGET_S", str(budget))
    rc = bench.main(["--device", "cpu"])
    out, err = capsys.readouterr()
    return rc, out, err


def test_main_on_cpu(monkeypatch, capsys):
    """(d) ``main`` with ``--device cpu`` at scale 0.05 and 2 frames: exit 0,
    one cumulative line after each of the 12 stages and a last one, the last
    with 8 parity entries within their gates, the plain backend, no failed
    or skipped stage, no kernel reading and no kernel launch."""
    rc, out, _ = run_main(monkeypatch, capsys, SCALE, 2)
    lines = [json.loads(line) for line in out.strip().splitlines()]
    assert rc == 0
    assert len(lines) == len(STAGES) + 1
    assert lines[0]["aux"]["pending"] == STAGES[1:]
    aux = lines[-1]["aux"]
    # Mrays/s are rounded to 2 decimals: a 64x36 frame on a loaded CPU reads 0.0
    assert lines[-1]["metric"] == "mrays_per_s_fwd_dingdong_1280x720"
    assert aux["frame_ms_fwd_dingdong"] > 0 and aux["frame_ms_fwd_bwd_dingdong"] > 0
    assert set(aux["parity_bad_px_fraction"]) == set(PARITY_GATES)
    assert all(v <= PARITY_GATES[k] for k, v in aux["parity_bad_px_fraction"].items())
    assert aux["forward_backend"] == "plain" and aux["device"] == "cpu"
    assert not {"failed", "pending", "skipped"} & set(aux)
    assert not any(k.startswith("kernel_ms_") for k in aux)
    assert aux["launches"]["render_fwd"] == aux["launches"]["render_bwd"] == 0
    for name in ("dingdong", "monkey_saddle", "reflection5b", "20spheres"):
        assert aux[f"mrays_per_s_fwd_bwd_{name}"] >= 0


def test_failed_stage_exits_nonzero(monkeypatch, capsys):
    """(e) A stage that raises is listed under ``failed`` in the line printed
    after it and at the end; the other stages still run, and the process
    exits nonzero."""
    def boom(*args, **kwargs):
        raise RuntimeError("made to fail")

    monkeypatch.setattr(bench, "_bench_fwdbwd", boom)
    rc, out, err = run_main(monkeypatch, capsys, SCALE, 1)
    lines = [json.loads(line) for line in out.strip().splitlines()]
    assert rc != 0 and "BENCH FAILED" in err and "made to fail" in err
    assert "PARITY GATE FAILED" not in err
    fwdbwd = sorted(s for s in STAGES if s.endswith(".fwdbwd"))
    assert lines[1]["aux"]["failed"] == ["dingdong.fwdbwd"]
    assert lines[-1]["aux"]["failed"] == fwdbwd
    assert len(lines[-1]["aux"]["parity_bad_px_fraction"]) == 8


def test_parity_breach_exits_one(monkeypatch, capsys):
    """(e) A golden replaced by zeros breaks the headline's gate: exit 1.
    A zero budget skips every stage after the headline, listed, without an
    error of its own."""
    monkeypatch.setattr(bench, "_load_golden",
                        lambda progress, name, scene, scale: np.zeros(
                            (scene.height, scene.width, 3), np.float32))
    rc, out, err = run_main(monkeypatch, capsys, SCALE, 1, budget=0)
    aux = last_json(out)["aux"]
    assert rc == 1 and "PARITY GATE FAILED" in err and "BENCH FAILED" not in err
    assert aux["parity_bad_px_fraction"]["dingdong"] > PARITY_GATES["dingdong"]
    assert aux["skipped"] == STAGES[1:] and "failed" not in aux


def test_default_device_needs_a_card(monkeypatch, capsys):
    """(f) With CUDA reported absent, the default device raises at start-up
    and no JSON line is printed."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        bench.main([])
    assert "cuda" in str(exc.value.code)
    assert capsys.readouterr().out == ""
