"""Gradients of the port's plain PyTorch pipeline.

Autograd through ``render_image`` (the IFT backward of ``ops/intersect.py``
and the tensor ops around it) against ``jax.grad`` of the JAX package's f32
XLA pipeline on dingdong 32x16 at pitch 5, all 9 parameter groups, under
the rule of the fused-backward tests (tests/test_pallas.py:174-181); the
XLA compile is the one tests/test_torch_grad.py makes, so the persistent
cache serves it. Then the f64 finite-difference checks of
tests/test_grads.py:85-163, on the port alone.
"""

import dataclasses

import numpy as np
import pytest
import torch

import tpu_ray_tracer as trt
import tpu_ray_tracer_torch as ttt
from tpu_ray_tracer.render.pipeline import RenderConfig as JRenderConfig
from tpu_ray_tracer_torch.models import surface as tsurface

from conftest import scene_path
from test_torch_grad import (DINGDONG_GROUPS, DINGDONG_POSE, assert_group_close, cotangent,
                             jax_grads, port_leaves, to_torch)

F32 = dict(geom_dtype="float32", polish_iters=3, bounces=0, chunk_px=None)
F64 = ttt.RenderConfig(geom_dtype="float64", polish_iters=0, bounces=0, chunk_px=None)


@pytest.fixture(scope="module")
def dingdong_pipeline_grads():
    jscene = dataclasses.replace(trt.load_from_file(scene_path("dingdong")), width=32,
                                 height=16)
    ref = jax_grads(jscene, DINGDONG_POSE, JRenderConfig(**F32), DINGDONG_GROUPS)
    s32, cam, leaves = port_leaves(to_torch(jscene), DINGDONG_POSE, DINGDONG_GROUPS)
    image = ttt.render_image(s32, cam, ttt.RenderConfig(**F32))
    (torch.as_tensor(cotangent(16, 32)) * image).sum().backward()
    return {g: leaves[g].grad.numpy() for g in DINGDONG_GROUPS}, ref


@pytest.mark.parametrize("group", DINGDONG_GROUPS)
def test_pipeline_gradient_matches_jax(dingdong_pipeline_grads, group):
    port, ref = dingdong_pipeline_grads
    assert_group_close(group, port[group], ref[group])


def _scene64(name):
    return dataclasses.replace(ttt.load_from_file(scene_path(name), device="cpu"), width=16,
                               height=12).astype(torch.float64)


def _mean_image(scene, camera=None):
    return ttt.render_image(scene, camera, F64).mean()


def test_coefficient_gradient_matches_finite_differences():
    """d mean(image) / d coefs[0, c] on quadratic 16x12 in f64 through trace,
    shade and shadows, against central differences (h 1e-5, rel 5e-3)."""
    scene = _scene64("quadratic")
    coefs = scene.coefs.clone().requires_grad_()
    _mean_image(dataclasses.replace(scene, coefs=coefs)).backward()
    g = coefs.grad
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0
    idx = (0, tsurface.COEF_INDEX["c"])
    h = 1e-5
    hi, lo = scene.coefs.clone(), scene.coefs.clone()
    hi[idx] += h
    lo[idx] -= h
    with torch.no_grad():
        fd = (float(_mean_image(dataclasses.replace(scene, coefs=hi)))
              - float(_mean_image(dataclasses.replace(scene, coefs=lo)))) / (2 * h)
    assert float(g[idx]) == pytest.approx(fd, rel=5e-3, abs=1e-8)


def test_camera_yaw_gradient_matches_finite_differences():
    """d mean(image) / d yaw on 20spheres 16x12 in f64 (h 1e-4, rel 1e-2)."""
    scene = _scene64("20spheres")

    def cam(yaw):
        return ttt.Camera(position=torch.zeros(3, dtype=torch.float64), yaw_deg=yaw,
                          pitch_deg=torch.zeros((), dtype=torch.float64))

    yaw = torch.tensor(90.0, dtype=torch.float64, requires_grad=True)
    _mean_image(scene, cam(yaw)).backward()
    g = float(yaw.grad)
    h = 1e-4
    with torch.no_grad():
        fd = (float(_mean_image(scene, cam(torch.tensor(90.0 + h, dtype=torch.float64))))
              - float(_mean_image(scene, cam(torch.tensor(90.0 - h, dtype=torch.float64))))
              ) / (2 * h)
    assert np.isfinite(g)
    assert g == pytest.approx(fd, rel=1e-2, abs=1e-7)


def test_light_gradient_flows():
    scene = _scene64("monkey_saddle")
    light_color = scene.light_color.clone().requires_grad_()
    _mean_image(dataclasses.replace(scene, light_color=light_color)).backward()
    assert torch.isfinite(light_color.grad).all()
    assert float(light_color.grad.abs().max()) > 0
