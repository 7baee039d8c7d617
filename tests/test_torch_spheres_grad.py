"""20spheres (20 spheres, 19 lights) through the port's kernel route at
32x16 on the CPU, where the kernels run as their plain twins: K2's 631
gradient rows against ``jax.grad`` of the JAX package's pipeline."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_ray_tracer as trt
import tpu_ray_tracer_torch as ttt
from tpu_ray_tracer.diff import inverse as jinv
from tpu_ray_tracer.parallel.sharding import make_mesh
from tpu_ray_tracer.render.pipeline import RenderConfig
from tpu_ray_tracer_torch.diff.inverse import (InverseProblem, make_train_step,
                                               params_from_arrays, params_to_arrays)
from tpu_ray_tracer_torch.models.loader import load_from_file
from tpu_ray_tracer_torch.render.bwd_kernel import acc_layout

from conftest import scene_path
from test_torch_grad import assert_group_close, jax_grads, port_grads, to_torch

GROUPS = ("coefs", "colors", "light_p", "light_color", "bg_color", "tan_half_fov",
          "position", "yaw_deg", "pitch_deg")
# The upstream window's starting pose pitched by 5 degrees, as dingdong's test
# (tests/test_torch_grad.py): at pitch 0 the frame is near symmetric about its
# middle row, and d/d pitch is a cancellation (-0.0146 in float64 at 32x16;
# K2 -0.0149, the port's f32 pipeline -0.0143) outside any rule on the group's size.
POSE = ((0.0, 0.0, 0.0), 90.0, 5.0)


@pytest.fixture(scope="module")
def k2_and_jax_grads():
    """Gradients of sum(w * image) at 32x16 with respect to every scene and
    camera table K2 writes rows for, through ``render_image_kernel`` (K1 and
    K2's plain twins and the packing's VJP) and through ``jax.grad`` of the
    JAX package's f32 pipeline."""
    jscene = dataclasses.replace(trt.load_from_file(scene_path("20spheres")), width=32,
                                 height=16)
    tscene = to_torch(jscene)
    assert (tscene.n_objects, tscene.n_lights) == (20, 19)
    assert acc_layout(20, 19)[-1] == 631
    config = RenderConfig(geom_dtype="float32", polish_iters=3, bounces=0, chunk_px=None)
    return (port_grads(tscene, POSE, GROUPS, polish_iters=3, bounces=0),
            jax_grads(jscene, POSE, config, GROUPS))


@pytest.mark.parametrize("group", GROUPS)
def test_k2_rows_match_jax(k2_and_jax_grads, group):
    """Each group of K2's rows, taken back to the scene's tables, within
    tests/test_pallas.py:172-181's rule of the JAX pipeline's gradient."""
    kernel, reference = k2_and_jax_grads
    assert np.abs(reference[group]).max() > 0, group
    assert_group_close(group, kernel[group], reference[group])


# --- the fit of ``20spheres.fit``: colours and light colours, three steps ---

FIT_FIELDS = ("colors", "light_color")


@pytest.fixture(scope="module")
def fit_case():
    """The benchmark cell's fit at 32x24: the JAX template with its albedos
    and light colours scaled by 0.6 (inside the mix's [0.5, 0.7]), the
    port's, the start parameters and the unperturbed scene's frame at the
    upstream's starting pose, by the forward kernel's route (its plain
    version here); and the JAX package's three train steps (losses, then
    the parameters after them), learning rate 5e-2, polish 2."""
    jscene = dataclasses.replace(trt.load_from_file(scene_path("20spheres")), width=32,
                                 height=24)
    jpert = dataclasses.replace(jscene, colors=np.asarray(jscene.colors) * np.float32(0.6),
                                light_color=np.asarray(jscene.light_color) * np.float32(0.6))
    tscene = dataclasses.replace(load_from_file(scene_path("20spheres"), device="cpu"),
                                 width=32, height=24)
    tpert = dataclasses.replace(tscene, colors=tscene.colors * 0.6,
                                light_color=tscene.light_color * 0.6)
    start = {k: np.asarray(v) for k, v in
             jinv.extract_params(jpert.astype(jnp.float32), FIT_FIELDS).items()}
    with torch.no_grad():
        target = ttt.render_image_kernel(tscene, _camera(), polish_iters=2).numpy()
    mesh = make_mesh()
    config = RenderConfig(geom_dtype="float32", polish_iters=2, bounces=0, chunk_px=None)
    jproblem = jinv.InverseProblem(scene_template=jpert, config=config,
                                   param_fields=FIT_FIELDS, learning_rate=5e-2)
    jstep = jinv.make_train_step(jproblem, mesh)
    jparams = {k: jnp.asarray(v) for k, v in start.items()}
    jstate = jproblem.optimizer().init(jparams)
    tgt = jinv.pad_target(jnp.asarray(target), mesh, jpert.height)
    cam = trt.Camera(position=jnp.zeros(3, jnp.float32), yaw_deg=jnp.float32(90.0),
                     pitch_deg=jnp.float32(0.0))
    losses = []
    for _ in range(3):
        jparams, jstate, jloss = jstep(jparams, jstate, cam, tgt)
        losses.append(float(jloss))
    return tpert, start, target, losses, {k: np.asarray(v) for k, v in jparams.items()}


def _camera():
    """The upstream window's starting pose, as the cell fits at it."""
    return ttt.Camera(position=torch.zeros(3), yaw_deg=torch.tensor(90.0),
                      pitch_deg=torch.tensor(0.0))


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_fit_steps_match_jax(fit_case, backend):
    """Three Adam steps of the albedo and light-colour fit through the port's
    ``make_train_step`` on the kernel route (K1 with aux, K2 and the
    packing's VJP as their plain twins) and on the pipeline route, against
    the JAX package's: the losses within 1e-4 relative, every parameter
    within 1e-4."""
    tpert, start, target, jlosses, jparams = fit_case
    config = ttt.RenderConfig(geom_dtype="float32", polish_iters=2, bounces=0, chunk_px=None)
    problem = InverseProblem(scene_template=tpert, config=config, param_fields=FIT_FIELDS,
                             learning_rate=5e-2, backend=backend)
    params = params_from_arrays(start, "cpu")
    optimizer = problem.optimizer(params)
    step = make_train_step(problem)
    camera = _camera()
    for jloss in jlosses:
        assert step(params, optimizer, camera, torch.from_numpy(target)) == \
            pytest.approx(jloss, rel=1e-4)
    got = params_to_arrays(params)
    for name in FIT_FIELDS:
        assert np.abs(got[name] - start[name]).max() > 1e-2, name
        np.testing.assert_allclose(got[name], jparams[name], rtol=0, atol=1e-4)
