"""Inverse rendering (``tpu_ray_tracer_torch/diff/inverse.py``) against the
JAX package's ``diff/inverse.py``, and the scenarios of tests/test_inverse.py
on the port.

Parity: the loss and its gradient against the JAX ``make_loss_fn`` (XLA
backend, the 8-device CPU mesh of tests/conftest.py) on clebsch 32x24, the
hard loss through both of the port's routes (the plain pipeline; the kernel
route, whose forward and backward kernels run their plain versions here)
and the soft loss; three train steps against JAX ``make_train_step`` from
the same start, carried across by ``params_from_arrays``. Both packages get
the same target array. Then the checkpoints (a round trip, a JAX-written
file, missing optimizer keys), the row-block backward, and the non-slow
scenarios of tests/test_inverse.py at their sizes and step budgets, the
Pallas backend's cases on the kernel route.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tpu_ray_tracer as trt
import tpu_ray_tracer_torch as ttt
from tpu_ray_tracer.diff import inverse as jinv
from tpu_ray_tracer.parallel.sharding import make_mesh
from tpu_ray_tracer.render.pipeline import RenderConfig as JaxRenderConfig
from tpu_ray_tracer_torch.diff.inverse import (InverseProblem, apply_params, extract_params,
                                               fit, load_checkpoint, make_loss_fn,
                                               make_train_step, pad_target, param_tensors,
                                               params_from_arrays, params_to_arrays,
                                               save_checkpoint)
from tpu_ray_tracer_torch.models.surface import COEF_INDEX
from tpu_ray_tracer_torch.render import kernel_backend

from conftest import scene_path
from test_torch_grad import assert_group_close

CONFIG = ttt.RenderConfig(geom_dtype="float32", polish_iters=2, bounces=0, chunk_px=None)
JAX_CONFIG = JaxRenderConfig(geom_dtype="float32", polish_iters=2, bounces=0, chunk_px=None)
FIELDS = ("coefs", "light_color")
SEED = 20261016


def pose(position=(0.0, 0.0, 0.0), yaw=90.0, pitch=0.0):
    return ttt.Camera(position=torch.tensor(position, dtype=torch.float32),
                      yaw_deg=torch.tensor(yaw, dtype=torch.float32),
                      pitch_deg=torch.tensor(pitch, dtype=torch.float32))


def jax_pose(position=(0.0, 0.0, 0.0), yaw=90.0, pitch=0.0):
    return trt.Camera(position=jnp.asarray(position, jnp.float32),
                      yaw_deg=jnp.asarray(yaw, jnp.float32),
                      pitch_deg=jnp.asarray(pitch, jnp.float32))


def load(name, width=32, height=24):
    return dataclasses.replace(ttt.load_from_file(scene_path(name), device="cpu"),
                               width=width, height=height)


def render_target(scene, camera=None, polish_iters=2, bounces=0):
    """The frame through the forward kernel's route (its plain version
    here), as the JAX tests render theirs through the Pallas kernel."""
    with torch.no_grad():
        return ttt.render_image_kernel(scene, camera or pose(), polish_iters=polish_iters,
                                       bounces=bounces)


# --- parity with the JAX package ---

@pytest.fixture(scope="module")
def clebsch_case():
    """clebsch 32x24 with a perturbed constant term and light colours: the
    JAX template, the port's, the start parameters as numpy (JAX
    ``extract_params``) and the target of the unperturbed scene."""
    jscene = dataclasses.replace(trt.load_from_file(scene_path("clebsch")), width=32, height=24)
    rng = np.random.default_rng(SEED)
    coefs = np.asarray(jscene.coefs).copy()
    coefs[0, COEF_INDEX["c"]] = 0.9
    light_color = np.asarray(jscene.light_color) * rng.uniform(0.7, 0.9, (jscene.n_lights, 1))
    jpert = dataclasses.replace(jscene, coefs=coefs, light_color=light_color.astype(np.float32))
    tpert = dataclasses.replace(load("clebsch"), coefs=torch.from_numpy(coefs),
                                light_color=torch.from_numpy(light_color.astype(np.float32)))
    start = {k: np.asarray(v) for k, v in
             jinv.extract_params(jpert.astype(jnp.float32), FIELDS).items()}
    target = render_target(load("clebsch")).numpy()
    return jpert, tpert, start, target


def _jax_value_and_grad(jpert, start, target, soft_tau):
    problem = jinv.InverseProblem(scene_template=jpert, config=JAX_CONFIG, param_fields=FIELDS,
                                  soft_tau=soft_tau)
    mesh = make_mesh()
    loss = jinv.make_loss_fn(problem, mesh)
    tgt = jinv.pad_target(jnp.asarray(target), mesh, jpert.height)
    value, grads = jax.jit(jax.value_and_grad(loss))(
        {k: jnp.asarray(v) for k, v in start.items()}, jax_pose(), tgt)
    return float(value), {k: np.asarray(v) for k, v in grads.items()}


@pytest.fixture(scope="module")
def jax_hard(clebsch_case):
    jpert, _, start, target = clebsch_case
    return _jax_value_and_grad(jpert, start, target, None)


@pytest.mark.parametrize("route", ["torch", "kernel", "soft"])
def test_loss_and_gradient_match_jax(clebsch_case, jax_hard, route, monkeypatch):
    """The loss value within 1e-4 relative of JAX ``make_loss_fn``'s and each
    parameter's gradient within tests/test_pallas.py:174-181's rule: the
    hard loss through the pipeline and through the kernel route, and the
    soft loss (tau 0.15) through the pipeline. The kernel route makes one
    ``render_bwd`` call, the pipeline routes none."""
    jpert, tpert, start, target = clebsch_case
    bwd_calls = []
    real_bwd = kernel_backend.render_bwd
    monkeypatch.setattr(kernel_backend, "render_bwd",
                        lambda *a, **k: bwd_calls.append(1) or real_bwd(*a, **k))
    soft_tau = 0.15 if route == "soft" else None
    ref_value, ref_grads = (jax_hard if soft_tau is None
                            else _jax_value_and_grad(jpert, start, target, soft_tau))
    problem = InverseProblem(scene_template=tpert, config=CONFIG, param_fields=FIELDS,
                             backend="kernel" if route == "kernel" else "torch",
                             soft_tau=soft_tau)
    loss_fn = make_loss_fn(problem)
    assert loss_fn.use_kernel == (route == "kernel")
    params = params_from_arrays(start, "cpu")
    value = loss_fn.backward(params, pose(), torch.from_numpy(target))
    assert value == pytest.approx(ref_value, rel=1e-4)
    assert len(bwd_calls) == (route == "kernel")
    for name in FIELDS:
        assert np.abs(ref_grads[name]).max() > 0, name
        assert_group_close(name, params[name].grad.numpy(), ref_grads[name])


def _train_steps_against_jax(clebsch_case, backend):
    """Three Adam steps (lr 1e-2) of the hard loss on ``backend``'s route
    from the same start as JAX ``make_train_step``: the losses within 1e-4
    relative and every parameter within 1e-4 of the JAX package's. Returns
    the port's train step and optimizer."""
    jpert, tpert, start, target = clebsch_case
    mesh = make_mesh()
    jproblem = jinv.InverseProblem(scene_template=jpert, config=JAX_CONFIG, param_fields=FIELDS)
    jstep = jinv.make_train_step(jproblem, mesh)
    jparams = {k: jnp.asarray(v) for k, v in start.items()}
    jstate = jproblem.optimizer().init(jparams)
    tgt = jinv.pad_target(jnp.asarray(target), mesh, jpert.height)
    problem = InverseProblem(scene_template=tpert, config=CONFIG, param_fields=FIELDS,
                             backend=backend)
    params = params_from_arrays(start, "cpu")
    optimizer = problem.optimizer(params)
    step = make_train_step(problem)
    for _ in range(3):
        jparams, jstate, jloss = jstep(jparams, jstate, jax_pose(), tgt)
        loss = step(params, optimizer, pose(), torch.from_numpy(target))
        assert loss == pytest.approx(float(jloss), rel=1e-4)
    got = params_to_arrays(params)
    for name in FIELDS:
        np.testing.assert_allclose(got[name], np.asarray(jparams[name]), rtol=0, atol=1e-4)
    return step, optimizer


def test_train_steps_match_jax(clebsch_case):
    """Three train steps through the pipeline against JAX's
    (``_train_steps_against_jax``)."""
    _train_steps_against_jax(clebsch_case, "torch")


def test_kernel_route_train_steps_match_jax(clebsch_case):
    """The fit step's eager path on the kernel route (its kernels run their
    plain versions here) against JAX's three train steps: on the CPU the
    optimizer is not capturable and the step captures no graph."""
    step, optimizer = _train_steps_against_jax(clebsch_case, "kernel")
    assert not optimizer.param_groups[0]["capturable"]
    assert step.graphs.captures == 0 and len(step.graphs._entries) == 0


def test_row_blocks_equal_one_shot():
    """The pipeline route's row-block backward (five blocks of five rows
    and one of one) gives the one-shot loss and gradient within 1e-5
    relative: only the f32 summation order differs."""
    scene = load("dingdong", 32, 26)
    target = render_target(scene, pose(pitch=5.0)) * 0.9
    problem = InverseProblem(scene_template=scene, config=CONFIG,
                             param_fields=("coefs", "light_color", "camera"))
    loss_fn = make_loss_fn(problem)
    assert loss_fn.block_rows == 26
    one = extract_params(scene, problem.param_fields, camera=pose(pitch=5.0))
    whole = loss_fn(one, None, target)
    whole.backward()
    blocks = extract_params(scene, problem.param_fields, camera=pose(pitch=5.0))
    loss_fn.block_rows = 5
    value = loss_fn.backward(blocks, None, target)
    assert float(value) == pytest.approx(float(whole.detach()), rel=1e-5)
    for a, b in zip(param_tensors(one), param_tensors(blocks)):
        scale = float(a.grad.abs().max())
        assert scale > 0
        assert float((a.grad - b.grad).abs().max()) <= 1e-5 * scale


# --- checkpoints ---

def _stepped(params):
    """An Adam optimizer over ``params`` with the state of one step on
    gradients 0.5, the parameters left as they were (an optax update that
    is not applied)."""
    opt = torch.optim.Adam(param_tensors(params), lr=1e-2)
    saved = [t.detach().clone() for t in param_tensors(params)]
    for t in param_tensors(params):
        t.grad = torch.full_like(t, 0.5)
    opt.step()
    with torch.no_grad():
        for t, v in zip(param_tensors(params), saved):
            t.copy_(v)
    return opt


def test_checkpoint_roundtrip_restores_opt_state_and_camera(tmp_path):
    """save/load restore the parameters, the camera and Adam's moments and
    step count (tests/test_inverse.py:359-390)."""
    params = {"light_color": torch.ones(2, 3, requires_grad=True),
              "camera": ttt.Camera(*(t.requires_grad_() for t in (
                  torch.tensor([1.0, 2.0, 3.0]), torch.tensor(92.0), torch.tensor(-1.5))))}
    opt = _stepped(params)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, params, opt, 7)
    fresh = {"light_color": torch.zeros(2, 3, requires_grad=True),
             "camera": ttt.Camera(*(t.requires_grad_() for t in (
                 torch.zeros(3), torch.tensor(90.0), torch.tensor(0.0))))}
    fresh_opt = torch.optim.Adam(param_tensors(fresh), lr=1e-2)
    assert load_checkpoint(path, fresh, fresh_opt) == 7
    state = fresh_opt.state[fresh["light_color"]]
    assert float(state["exp_avg"].abs().max()) > 0.01, "optimizer moments not restored"
    assert float(state["step"]) == 1
    torch.testing.assert_close(state["exp_avg_sq"], opt.state[params["light_color"]]["exp_avg_sq"])
    assert float(fresh["camera"].yaw_deg.detach()) == 92.0
    np.testing.assert_allclose(fresh["camera"].position.detach().numpy(), [1.0, 2.0, 3.0])
    # the restored optimizer takes the same next step as the saved one
    for p in (params, fresh):
        for t in param_tensors(p):
            t.grad = torch.full_like(t, -0.25)
    opt.step()
    fresh_opt.step()
    for a, b in zip(param_tensors(params), param_tensors(fresh)):
        assert torch.equal(a, b)
    assert load_checkpoint(str(tmp_path / "absent.npz"), fresh) is None


def test_checkpoint_without_optimizer_keys_raises(tmp_path):
    """A checkpoint whose ``opt/...`` keys are missing raises on resume
    instead of restarting Adam's moments from zero; the parameters alone
    still load."""
    params = {"light_color": torch.ones(2, 3, requires_grad=True)}
    opt = _stepped(params)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, params, opt, 3)
    with np.load(path) as data:
        kept = {k: data[k] for k in data.files if not k.startswith("opt/")}
    np.savez(path, **kept)
    fresh = {"light_color": torch.zeros(2, 3, requires_grad=True)}
    with pytest.raises(KeyError, match="opt/light_color/exp_avg"):
        load_checkpoint(path, fresh, torch.optim.Adam(param_tensors(fresh)))
    assert load_checkpoint(path, fresh) == 3
    assert torch.equal(fresh["light_color"].detach(), params["light_color"].detach())


def test_jax_checkpoint_params_load(tmp_path):
    """The ``params/...`` keys of a checkpoint the JAX package writes (a
    light table and a camera, from a numpy seed) load into the port's
    parameters."""
    rng = np.random.default_rng(SEED)
    lc = rng.uniform(0.5, 1.5, (6, 3)).astype(np.float32)
    jparams = {"light_color": jnp.asarray(lc), "camera": jax_pose((0.5, -1.0, 2.0), 91.0, 3.0)}
    path = str(tmp_path / "jax.npz")
    jinv.save_checkpoint(path, jparams, optax.adam(1e-2).init(jparams), 11)
    params = {"light_color": torch.zeros(6, 3, requires_grad=True),
              "camera": ttt.Camera(*(t.requires_grad_() for t in (
                  torch.zeros(3), torch.tensor(90.0), torch.tensor(0.0))))}
    assert load_checkpoint(path, params) == 11
    np.testing.assert_array_equal(params["light_color"].detach().numpy(), lc)
    arrays = params_to_arrays(params)
    np.testing.assert_array_equal(arrays["camera"]["position"], np.float32([0.5, -1.0, 2.0]))
    assert float(arrays["camera"]["yaw_deg"]) == 91.0
    assert float(arrays["camera"]["pitch_deg"]) == 3.0
    with pytest.raises(KeyError, match="optimizer state"):
        load_checkpoint(path, params, torch.optim.Adam(param_tensors(params)))


# --- the scenarios of tests/test_inverse.py ---

def test_recover_clebsch_light_params():
    """40 Adam steps (lr 5e-2) on the light colours of clebsch 32x24, started
    at 0.55x: the loss falls 20x and the recovered frame is within 0.04 of
    the target (tests/test_inverse.py:32-88)."""
    scene = load("clebsch")
    target = render_target(scene)
    perturbed = dataclasses.replace(scene, light_color=scene.light_color * 0.55)
    problem = InverseProblem(scene_template=perturbed, config=CONFIG, learning_rate=5e-2,
                             param_fields=("light_color",))
    params = extract_params(perturbed.astype(torch.float32), ("light_color",))
    opt = problem.optimizer(params)
    step = make_train_step(problem)
    tgt = pad_target(target, scene.height)
    losses = [step(params, opt, pose(), tgt) for _ in range(40)]
    assert np.isfinite(losses).all()
    assert losses[0] > 1e-5
    assert min(losses) < losses[0] * 0.05, (losses[0], min(losses))
    recovered = render_target(apply_params(perturbed.astype(torch.float32),
                                           {k: v.detach() for k, v in params.items()}))
    assert float((recovered - target).abs().max()) < 0.04


def test_loss_landscape_minimum_at_truth():
    """The loss over the Clebsch constant term is smallest at the true value
    (tests/test_inverse.py:91-125)."""
    scene = load("clebsch")
    target = render_target(scene)
    loss_fn = make_loss_fn(InverseProblem(scene_template=scene, config=CONFIG,
                                          param_fields=("coefs",)))
    losses = {}
    for cval in (0.8, 1.0, 1.2):
        c = scene.coefs.to(torch.float32).clone()
        c[0, COEF_INDEX["c"]] = cval
        with torch.no_grad():
            losses[cval] = float(loss_fn({"coefs": c}, pose(), target))
    assert losses[1.0] < 1e-8
    assert losses[0.8] > losses[1.0]
    assert losses[1.2] > losses[1.0]


def _adaptive_case(flip):
    """quadratic 24x16 from (0, -25, 0), curvature and linear terms
    perturbed; ``flip`` lists the ground plane first."""
    scene = load("quadratic", 24, 16)
    if flip:
        scene = dataclasses.replace(scene, coefs=scene.coefs.flip(0),
                                    colors=scene.colors.flip(0),
                                    reflection=scene.reflection.flip(0))
    cam = pose((0.0, -25.0, 0.0))
    target = render_target(scene, cam)
    coefs = scene.coefs.clone()
    coefs[:, 10:16] *= 1.25
    coefs[:, 16:19] *= 0.9
    perturbed = dataclasses.replace(scene, coefs=coefs)
    problem = InverseProblem(scene_template=perturbed, config=CONFIG, param_fields=("coefs",),
                             backend="kernel", learning_rate=2e-3)
    return problem, cam, target


@pytest.mark.parametrize("flip", [False, True])
def test_fit_adaptive_repartition_kernel(flip):
    """fit() on the kernel route with optimized coefficients derives the
    solver routing from the current iterate (tests/test_inverse.py:128-168).
    Both objects start as quadrics (no cubic slot); the first Adam step
    gives the visible paraboloid cubic entries (the unseen ground plane's
    gradient is 0, so it stays quadric), and the statics, keyed on the
    coefficient tensor's version counter, re-route it through the cubic
    solve: with the plane listed first, the paraboloid's slot moves to the
    front (the permutation changes). Descent still lowers the loss over 10
    steps, and ``fit`` takes the same steps."""
    problem, cam, target = _adaptive_case(flip)
    params = extract_params(problem.scene_template.astype(torch.float32), ("coefs",))
    statics = [kernel_backend._statics_for(params["coefs"])]
    opt = problem.optimizer(params)
    step = make_train_step(problem)
    losses = []
    for _ in range(10):
        losses.append(step(params, opt, cam, target))
        statics.append(kernel_backend._statics_for(params["coefs"]))
    assert statics[0][:2] == ((0, 1), 0), statics[0]
    assert statics[1][:2] == (((1, 0) if flip else (0, 1)), 1), statics[1]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    _, fit_losses = fit(problem, target, camera=cam, steps=10, log_every=0)
    assert fit_losses == losses


def test_recover_camera_pose():
    """Pose recovery through the 'camera' pseudo-field on the pipeline route:
    80 steps (lr 4e-2) from a perturbed pose lower the loss 20x and the
    recovered pose reproduces the target within 2/255
    (tests/test_inverse.py:179-220)."""
    scene = load("quadratic")
    true_cam = pose((0.0, -25.0, 0.0))
    target = render_target(scene, true_cam)
    problem = InverseProblem(scene_template=scene, config=CONFIG, param_fields=("camera",),
                             learning_rate=4e-2)
    params, losses = fit(problem, target, camera=pose((0.4, -24.7, 0.2), 92.0, -1.0),
                         steps=80, log_every=0)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.05, (losses[0], losses[-1])
    cam = ttt.Camera(*(getattr(params["camera"], f).detach()
                       for f in ("position", "yaw_deg", "pitch_deg")))
    assert float((render_target(scene, cam) - target).abs().max()) < 2.0 / 255.0


@pytest.mark.slow  # 150 soft-render steps of 20spheres
def test_camera_pose_soft_visibility_descent():
    """Pose descent through the soft render with tau continuation 0.15 ->
    2e-3 over 150 steps lowers the loss 30x on 20spheres 40x24
    (tests/test_inverse.py:223-257)."""
    scene = load("20spheres", 40, 24)
    target = render_target(scene)
    problem = InverseProblem(scene_template=scene, config=CONFIG, param_fields=("camera",),
                             learning_rate=3e-2, soft_tau=0.15)
    _, losses = fit(problem, target, camera=pose((0.3, -0.2, 0.15), 92.0, -1.0), steps=150,
                    log_every=0, tau_final=2e-3)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] / 30.0, (losses[0], losses[-1])


def _camera_grads(render, scene, cam):
    leaves = [getattr(cam, f).clone().requires_grad_() for f in ("position", "yaw_deg",
                                                                   "pitch_deg")]
    render(scene, ttt.Camera(*leaves)).sum().backward()
    return [leaf.grad.numpy() for leaf in leaves]


@pytest.mark.parametrize("name,bounces,cam,tol", [
    ("dingdong", 0, ((0.1, 0.2, -0.3), 87.0, 4.0), 2e-2),
    ("reflection_test", 1, ((0.0, 0.0, 0.0), 88.0, -3.0), 5e-3),
])
def test_camera_grad_kernel_matches_pipeline(name, bounces, cam, tol):
    """Camera gradients of the kernel route (the fused backward's camera
    rows, chained to position, yaw and pitch) against the pipeline's
    autograd at polish 3, within ``tol`` of the largest entry
    (tests/test_inverse.py:260-330; with a reflection chain, bounces 1)."""
    height = 16 if name == "dingdong" else 24
    scene = load(name, 32, height).astype(torch.float32)
    cam = pose(*cam)
    config = ttt.RenderConfig(geom_dtype="float32", polish_iters=3, bounces=bounces,
                              chunk_px=None)
    got = _camera_grads(lambda s, c: ttt.render_image_kernel(s, c, polish_iters=3,
                                                             bounces=bounces), scene, cam)
    ref = _camera_grads(lambda s, c: ttt.render_image(s, c, config), scene, cam)
    for a, b, group in zip(got, ref, ("position", "yaw", "pitch")):
        assert np.isfinite(a).all(), group
        scale = max(np.abs(b).max(), 1e-3)
        assert np.abs(a - b).max() / scale < tol, (group, a, b)
    assert np.abs(ref[1]) > 0


def test_fit_camera_pose_kernel_backend():
    """A pose fit on the kernel route descends in 10 steps
    (tests/test_inverse.py:333-356)."""
    scene = load("quadratic", 24, 16)
    target = render_target(scene, pose((0.0, -25.0, 0.0)))
    problem = InverseProblem(scene_template=scene, config=CONFIG, param_fields=("camera",),
                             learning_rate=3e-2, backend="kernel")
    _, losses = fit(problem, target, camera=pose((0.2, -24.9, 0.1), 91.5, -0.7), steps=10,
                    log_every=0)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
