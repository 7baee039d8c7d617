"""Gradients of the PyTorch port's render against ``jax.grad`` of the JAX
package.

On the CPU ``render_image_kernel`` followed by ``loss.backward()`` runs the
plain versions of both kernels (``render_fwd_plain`` with ``save_aux`` and
``render_bwd_plain``). These tests hold its gradients to ``jax.grad`` of
the JAX package's f32 XLA pipeline (``_render_image_jit``) at the sizes and
with the limits of the JAX package's own fused-backward tests
(tests/test_pallas.py:124-181, tests/test_degenerate.py:294-326), and check
the routing of ``render_image_kernel``. The reflective chain and the
stage-0 aux are in tests/test_torch_grad_chain.py (one XLA compile each, on
separate workers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_ray_tracer as trt
import tpu_ray_tracer_torch as ttt
from tpu_ray_tracer.render.pipeline import RenderConfig, _render_image_jit
from tpu_ray_tracer_torch.models import light as tlight
from tpu_ray_tracer_torch.models import surface as tsurface
from tpu_ray_tracer_torch.models.scene import Object, camera_from_arrays, scene_from_arrays
from tpu_ray_tracer_torch.render import kernel_backend
from tpu_ray_tracer_torch.render.bwd_kernel import acc_layout, render_bwd, split_grad
from tpu_ray_tracer_torch.render.fwd_kernel import render_fwd
from tpu_ray_tracer_torch.render.kernel_backend import pack_frame, render_rows_kernel

from conftest import scene_path
from test_degenerate import _scene_many_lights

FIELDS = ("coefs", "colors", "reflection", "light_p", "light_color",
          "light_is_spherical", "bg_color", "tan_half_fov")
CAMERA_FIELDS = ("position", "yaw_deg", "pitch_deg")
DINGDONG_GROUPS = ("coefs", "light_color", "light_p", "colors", "bg_color",
                   "tan_half_fov", "position", "yaw_deg", "pitch_deg")


def to_torch(jscene):
    """The JAX package's scene as a port scene with equal tables."""
    return scene_from_arrays(*(np.asarray(getattr(jscene, f)) for f in FIELDS),
                             jscene.width, jscene.height, jscene.max_reflections,
                             device="cpu")


def cotangent(height, width):
    """Non-uniform weights, so every pixel's contribution is distinct
    (tests/test_pallas.py:150); f64, as ``jnp.linspace`` under x64."""
    return np.linspace(0.1, 1.0, height * width * 3).reshape(height, width, 3)


def jax_grads(jscene, pose, config, groups, weights=None):
    """``jax.grad`` of sum(w * image) of the f32 XLA pipeline with respect
    to the named scene and camera fields of the f32 scene."""
    scene32 = jax.tree.map(jnp.asarray, jscene.astype(jnp.float32))
    pos, yaw, pitch = pose
    cam = trt.Camera(position=jnp.asarray(pos, jnp.float32),
                     yaw_deg=jnp.asarray(yaw, jnp.float32),
                     pitch_deg=jnp.asarray(pitch, jnp.float32))
    w = jnp.asarray(cotangent(jscene.height, jscene.width) if weights is None else weights)

    def loss(*args):
        vals = dict(zip(groups, args))
        s = dataclasses.replace(scene32, **{k: v for k, v in vals.items() if k in FIELDS})
        c = dataclasses.replace(cam, **{k: v for k, v in vals.items() if k in CAMERA_FIELDS})
        return jnp.sum(w * _render_image_jit(s, c, config))

    args = [getattr(scene32 if g in FIELDS else cam, g) for g in groups]
    grads = jax.grad(loss, argnums=tuple(range(len(groups))))(*args)
    return {g: np.asarray(v) for g, v in zip(groups, grads)}


def port_leaves(tscene, pose, groups):
    """The f32 scene and camera with the named tensors as grad leaves."""
    s32 = tscene.astype(torch.float32)
    cam = camera_from_arrays(np.float32(pose[0]), np.float32(pose[1]), np.float32(pose[2]),
                             "cpu")
    leaves = {g: getattr(s32 if g in FIELDS else cam, g).clone().requires_grad_()
              for g in groups}
    s32 = dataclasses.replace(s32, **{k: v for k, v in leaves.items() if k in FIELDS})
    cam = dataclasses.replace(cam, **{k: v for k, v in leaves.items() if k in CAMERA_FIELDS})
    return s32, cam, leaves


def port_grads(tscene, pose, groups, weights=None, **render_kw):
    s32, cam, leaves = port_leaves(tscene, pose, groups)
    image = ttt.render_image_kernel(s32, cam, **render_kw)
    w = torch.as_tensor(cotangent(tscene.height, tscene.width) if weights is None
                        else weights)
    (w * image).sum().backward()
    return {g: leaves[g].grad.numpy() for g in groups}


def assert_group_close(group, port, ref):
    """tests/test_pallas.py:174-181: relative error of the whole group
    against its largest reference entry below 2e-3, or below 2e-2 where
    that entry is at most 1 (small gradients such as pitch carry more f32
    cancellation noise relative to their size)."""
    assert port.shape == ref.shape, group
    assert np.isfinite(port).all(), group
    scale = max(np.abs(ref).max(), 1e-6)
    relerr = np.abs(port - ref).max() / scale
    tol = 2e-3 if np.abs(ref).max() > 1.0 else 2e-2
    assert relerr < tol, f"{group}: relerr {relerr:.2e} (tol {tol})"


DINGDONG_POSE = ((0.0, 0.0, 0.0), 90.0, 5.0)


@pytest.fixture(scope="module")
def dingdong_grads():
    jscene = dataclasses.replace(trt.load_from_file(scene_path("dingdong")), width=32,
                                 height=16)
    config = RenderConfig(geom_dtype="float32", polish_iters=3, bounces=0, chunk_px=None)
    ref = jax_grads(jscene, DINGDONG_POSE, config, DINGDONG_GROUPS)
    port = port_grads(to_torch(jscene), DINGDONG_POSE, DINGDONG_GROUPS, bounces=0)
    return port, ref


@pytest.mark.parametrize("group", DINGDONG_GROUPS)
def test_dingdong_gradient_matches_jax(dingdong_grads, group):
    """dingdong at 32x16, bounces=0, pitch 5 (tests/test_pallas.py:124-181):
    cubics, both light kinds and the degree partition."""
    port, ref = dingdong_grads
    assert_group_close(group, port[group], ref[group])


def test_31_light_boundary_gradient_matches_jax():
    """Exactly 31 lights, the last count the i32 occlusion mask holds, take
    the fused path; the light_color gradient matches the XLA pipeline
    within 5e-3 of its scale (tests/test_degenerate.py:294-326: the f32
    lit sums over 31 lights round differently)."""
    jscene = _scene_many_lights(n=31, width=24, height=8)
    assert jscene.n_lights == 31
    weights = np.ones((8, 24, 3))
    config = RenderConfig(geom_dtype="float32", polish_iters=2, bounces=0, chunk_px=None)
    ref = jax_grads(jscene, ((0.0, 0.0, 0.0), 90.0, 0.0), config, ("light_color",),
                    weights)["light_color"]
    before = render_bwd.launches
    port = port_grads(to_torch(jscene), ((0.0, 0.0, 0.0), 90.0, 0.0), ("light_color",),
                      weights, polish_iters=2, bounces=0)["light_color"]
    assert render_bwd.launches == before  # the plain version on the CPU
    assert np.isfinite(port).all() and np.abs(port).max() > 0
    scale = max(np.abs(ref).max(), 1e-6)
    assert np.abs(port - ref).max() / scale < 5e-3


class _FwdSpy:
    """Records the ``save_aux`` flag of every ``render_fwd`` call that the
    render entries make."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = kernel_backend.render_fwd

        def spy(*args, **kw):
            self.calls.append(kw.get("save_aux", False))
            return real(*args, **kw)

        monkeypatch.setattr(kernel_backend, "render_fwd", spy)


def _ding(width=32, height=16):
    return to_torch(dataclasses.replace(trt.load_from_file(scene_path("dingdong")),
                                        width=width, height=height))


def test_no_grad_path_saves_no_aux(monkeypatch):
    """A frame that autograd does not record renders without aux, and the
    image with aux is bitwise the image without."""
    spy = _FwdSpy(monkeypatch)
    tscene = _ding()
    plain = ttt.render_image_kernel(tscene)
    s32, cam, leaves = port_leaves(tscene, DINGDONG_POSE, ("coefs", "position"))
    with torch.no_grad():
        no_grad = ttt.render_image_kernel(s32, cam)
    with_grad = ttt.render_image_kernel(s32, cam)
    assert spy.calls == [False, False, True]
    assert plain.grad_fn is None and no_grad.grad_fn is None
    assert with_grad.grad_fn is not None
    assert torch.equal(with_grad.detach(), no_grad)


class _BwdSpy:
    """Records every ``render_bwd`` call of the render entries."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = kernel_backend.render_bwd

        def spy(*args, **kw):
            self.calls += 1
            return real(*args, **kw)

        monkeypatch.setattr(kernel_backend, "render_bwd", spy)


@pytest.mark.parametrize("case", ["33_lights", "no_objects"])
def test_gradient_outside_fused_domain_raises(monkeypatch, case):
    """Scenes the fused backward cannot encode (more than 31 lights, or no
    object) take the pipeline fallback in ``render_image_kernel``: one
    ``render_fwd`` without aux, no ``render_bwd``, and the gradient of the
    plain pipeline. On 33 lights it equals ``jax.grad`` of the JAX
    package's XLA pipeline with tests/test_degenerate.py:87-120's limits
    (rtol 1e-5 light_color, 1e-4 coefs); with no object the light
    gradient is finite and zero (:145-169). The row-block entry
    ``render_rows_kernel`` stays forward-only for such scenes and raises,
    naming ``render_image_kernel``."""
    pose = ((0.0, 0.0, 0.0), 90.0, 0.0)
    if case == "33_lights":
        jscene = _scene_many_lights(n=33, width=32, height=16)
        tscene, groups = to_torch(jscene), ("light_color", "coefs")
    else:
        tscene = ttt.build_scene(16, 8, 60.0, [], [tlight.directional(
            1.0, (0.0, -1.0, 0.0), (1.0, 1.0, 1.0))], bg_color=(0.3, 0.6, 0.9), device="cpu")
        groups = ("light_color", "bg_color")
    s32, cam, leaves = port_leaves(tscene, pose, groups)
    with torch.no_grad():
        image = ttt.render_image_kernel(s32, cam)
    fwd, bwd = _FwdSpy(monkeypatch), _BwdSpy(monkeypatch)
    out = ttt.render_image_kernel(s32, cam)
    assert out.grad_fn is not None and torch.equal(out.detach(), image)
    out.sum().backward()
    assert fwd.calls == [False] and bwd.calls == 0
    grads = {g: leaves[g].grad.numpy() for g in groups}
    assert all(np.isfinite(g).all() for g in grads.values())
    if case == "33_lights":
        config = RenderConfig(geom_dtype="float32", polish_iters=3, bounces=0, chunk_px=None)
        ref = jax_grads(jscene, pose, config, groups, np.ones((16, 32, 3)))
        assert np.abs(grads["light_color"]).max() > 0
        np.testing.assert_allclose(grads["light_color"], ref["light_color"], rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(grads["coefs"], ref["coefs"], rtol=1e-4,
                                   atol=1e-6 * max(1.0, np.abs(ref["coefs"]).max()))
    else:
        np.testing.assert_array_equal(grads["light_color"], 0.0)
        np.testing.assert_array_equal(grads["bg_color"], np.full(3, 16 * 8, np.float32))
    with pytest.raises(NotImplementedError, match="render_image_kernel"):
        render_rows_kernel(s32, cam, 0, 4)


def test_row_block_gradients_sum_to_frame():
    """The gradients of three row blocks sum to the full frame's within 1e-4
    of each group's scale: only the f32 summation order differs (the row
    sharding semantics, pallas_backend.py:2183-2189). Width 64 keeps the
    CPU forward bit-stable across blocks (see tests/test_torch_render.py)."""
    tscene = _ding(64, 30)
    groups = ("coefs", "colors", "light_p", "light_color", "bg_color", "tan_half_fov",
              "position", "yaw_deg", "pitch_deg")
    w = torch.as_tensor(cotangent(30, 64))
    s32, cam, leaves = port_leaves(tscene, DINGDONG_POSE, groups)
    (w * ttt.render_image_kernel(s32, cam)).sum().backward()
    full = {g: leaves[g].grad.clone() for g in groups}
    for leaf in leaves.values():
        leaf.grad = None
    for r0, r1 in ((0, 7), (7, 19), (19, 30)):
        (w[r0:r1] * render_rows_kernel(s32, cam, r0, r1 - r0)).sum().backward()
    for g in groups:
        scale = float(full[g].abs().max())
        assert scale > 0, g
        assert float((leaves[g].grad - full[g]).abs().max()) <= 1e-4 * scale, g


def test_optimizer_step_refreshes_statics():
    """An in-place Adam step on the leaf ``coefs`` turns the quadric slots
    cubic: the memoised statics must follow the version counter, so the
    next gradient equals, bitwise, that of a freshly built scene with the
    same coefficients."""
    objects = [Object(tsurface.sphere((0.0, 0.0, 6.0), 2.0), 0.0, np.float32([0.8, 0.3, 0.2])),
               Object(tsurface.plane((0.0, -3.0, 0.0), (0.0, 1.0, 0.0)), 0.0,
                      np.float32([0.2, 0.6, 0.9]))]
    lights = [tlight.directional(1.5, (0.3, -1.0, 0.5), (1.0, 1.0, 1.0)),
              tlight.spherical(300.0, (0.0, 4.0, 2.0), (1.0, 0.9, 0.8))]
    tscene = ttt.build_scene(32, 16, 60.0, objects, lights, bg_color=(0.1, 0.1, 0.1),
                             device="cpu")
    coefs = tscene.coefs.clone().requires_grad_()
    scene = dataclasses.replace(tscene, coefs=coefs)
    assert kernel_backend._statics_for(coefs)[1] == 0  # both quadrics
    opt = torch.optim.Adam([coefs], lr=1e-2)
    w = torch.as_tensor(cotangent(16, 32))
    (w * ttt.render_image_kernel(scene)).sum().backward()
    opt.step()
    opt.zero_grad()
    assert kernel_backend._statics_for(coefs)[1] == 2  # both slots turned cubic
    (w * ttt.render_image_kernel(scene)).sum().backward()
    fresh = coefs.detach().clone().requires_grad_()
    (w * ttt.render_image_kernel(dataclasses.replace(tscene, coefs=fresh))).sum().backward()
    assert torch.isfinite(coefs.grad).all()
    assert torch.equal(coefs.grad, fresh.grad)


def test_wrappers_reject_bad_arguments():
    """The aux needs an i32 mask (at most 31 lights); render_bwd validates
    its tables, cotangent and aux as render_fwd does, and has no kernel
    for a device other than CPU or CUDA."""
    tables, kw = pack_frame(to_torch(_scene_many_lights(n=32, width=8, height=4)),
                            camera_from_arrays(np.zeros(3, np.float32), np.float32(90.0),
                                               np.float32(0.0), "cpu"), 0, 4)
    with pytest.raises(ValueError, match="at most 31 lights"):
        render_fwd(*tables, **kw, save_aux=True)
    tscene = _ding(8, 4)
    tables, kw = pack_frame(tscene, camera_from_arrays(np.zeros(3, np.float32),
                                                       np.float32(90.0), np.float32(0.0),
                                                       "cpu"), 0, 4)
    _, *aux = render_fwd(*tables, **kw, save_aux=True)
    args = [tables[0], tables[2], tables[3], tables[4], tables[7], torch.ones(4, 8, 3), *aux]
    bkw = dict(width=8, height=4, rows=4, n_lights=2, bounces=0)
    vec = render_bwd(*args, **bkw)
    assert vec.shape == (acc_layout(3, 2)[-1],) == (104,)
    assert set(split_grad(vec, 3, 2)) == {"cam", "coefs", "colors", "lights", "refl"}
    with pytest.raises(ValueError, match="grad_image has shape"):
        render_bwd(*args[:5], torch.ones(4, 7, 3), *aux, **bkw)
    with pytest.raises(ValueError, match="aux_slot must be a contiguous"):
        render_bwd(*args[:7], aux[1].float(), aux[2], **bkw)
    with pytest.raises(ValueError, match="aux_t has shape"):
        render_bwd(*args, **{**bkw, "bounces": 1})
    with pytest.raises(ValueError, match="n_lights=3"):
        render_bwd(*args, **{**bkw, "n_lights": 3})
    with pytest.raises(ValueError, match="no kernel for device"):
        render_bwd(*(t.to("meta") for t in args), **bkw)
