"""The packing of a frame's tables and its VJP (``render/pack_kernel.py``)
against the JAX package, on the CPU, where the wrappers run the plain
versions.

``pack_tables_plain`` against the packing of ``_render_pallas_jit``: the
cubics-first ``jnp.take`` of the f32 tables, ``_pack_lights``,
``_pack_camera`` and ``_dir_form_table``, all plain jnp. ``pack_vjp_plain``
against ``jax.vjp`` of that packing and against torch's autograd through
``pack_tables_plain``. The frame through ``FrameRender`` (the packing and
its VJP as the two kernels' plain versions) against the earlier path,
``PackedRender`` with autograd through the packing. The frame's gradient
against ``jax.grad`` of the XLA pipeline is tests/test_torch_grad.py's.
The card's kernels against these plain versions are in
tests/test_torch_gpu.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_ray_tracer as trt
import tpu_ray_tracer_torch as ttt
from tpu_ray_tracer.render import pallas_backend as pb
from tpu_ray_tracer_torch.models.scene import camera_from_arrays
from tpu_ray_tracer_torch.render import kernel_backend as kb
from tpu_ray_tracer_torch.render.bwd_kernel import acc_layout, split_grad
from tpu_ray_tracer_torch.render.pack_kernel import (GRAD_FIELDS, grad_tensors, pack_tables,
                                                     pack_tables_plain, pack_vjp,
                                                     pack_vjp_plain)

from conftest import SCENE_NAMES, scene_path

POSES = [((0.0, 0.0, 0.0), 90.0, 0.0), ((0.0, 2.0, -3.0), 75.0, -12.0),
         ((1.5, -0.5, 4.0), -30.0, 40.0)]
# The camera rows against XLA's: sin, cos and sqrt come from two math
# libraries and round in other last bits, which the cross products and the
# normalisations carry on.
CAMERA_ULPS = 4
# The direction-form table against XLA's: a [L, 10] @ [10, N] product at
# HIGHEST precision (Eigen, with FMAs) against products and a sum, each
# rounded: within 4 f32 ulps of the largest term's magnitude.
DIR_TABLE_TERM_ULPS = 4
# Gradients of yaw, pitch and tan_half_fov (and the position, f32 either
# way): a closed form against autograd's or JAX's reverse sweep, which round
# the normalisations' backward in another order.
CAMERA_GRAD_RTOL = 1e-5
_TABLES = ("coefs", "orig_index", "colors", "refl", "lights", "dir_table", "posdef", "cam")


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in f32 units in the last place between a and b."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max()) if ia.size else 0


def _scenes(name):
    return (trt.load_from_file(scene_path(name)),
            ttt.load_from_file(scene_path(name), device="cpu"))


def _cameras(pose):
    pos, yaw, pitch = pose
    jc = trt.Camera(position=jnp.asarray(pos, jnp.float32), yaw_deg=jnp.asarray(yaw, jnp.float32),
                    pitch_deg=jnp.asarray(pitch, jnp.float32))
    tc = camera_from_arrays(np.float32(pos), np.float32(yaw), np.float32(pitch), "cpu")
    return jc, tc


def _jax_pack(jscene, perm, n_cubic, row0):
    """The packing of ``_render_pallas_jit`` (pallas_backend.py:1464-1478,
    the direction-form table of ``_dispatch_fwd`` :1432) as a function of
    the scene's and camera's differentiable arrays: (coefs, colors, refl,
    lights, cam) and the direction-form table."""
    idx = jnp.asarray(np.asarray(perm, np.int64))

    def pack(coefs, colors, refl, light_p, light_color, bg, tanf, position, yaw, pitch):
        scene = dataclasses.replace(jscene, coefs=coefs, colors=colors, reflection=refl,
                                    light_p=light_p, light_color=light_color, bg_color=bg,
                                    tan_half_fov=tanf)
        scene32 = scene.astype(jnp.float32)
        cam32 = trt.Camera(position=position.astype(jnp.float32),
                           yaw_deg=yaw.astype(jnp.float32), pitch_deg=pitch.astype(jnp.float32))
        c = jnp.take(scene32.coefs, idx, axis=0)
        lights = pb._pack_lights(scene32)
        tables = (c, jnp.take(scene32.colors, idx, axis=0),
                  jnp.take(scene32.reflection, idx, axis=0), lights,
                  pb._pack_camera(scene32, cam32, row0=row0))
        return tables, pb._dir_form_table(c, lights, n_cubic)

    return pack


def _jax_args(jscene, jcam):
    return (jscene.coefs, jscene.colors, jscene.reflection, jscene.light_p, jscene.light_color,
            jscene.bg_color, jscene.tan_half_fov, jcam.position, jcam.yaw_deg, jcam.pitch_deg)


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_pack_tables_plain_matches_jax(name):
    """The 8 tables on every bundled scene at 3 poses and row0 0 and 13:
    the slot gathers, orig_index, posdef and the light table bit for bit;
    the camera rows within CAMERA_ULPS; the direction-form table within
    DIR_TABLE_TERM_ULPS of its largest term. The wrapper on CPU tensors is
    the plain version and counts no launch."""
    jscene, tscene = _scenes(name)
    host = kb._host_half(tscene, 3, None, None)
    perm, n_cubic, posdef = pb._statics_for(jnp.asarray(np.asarray(jscene.coefs)))
    assert host["n_cubic"] == n_cubic
    lp = np.asarray(jscene.light_p, np.float32)
    coefs32 = np.asarray(jscene.coefs, np.float32)[list(perm)]
    for pose in POSES:
        jc, tc = _cameras(pose)
        for row0 in (0, 13):
            (jcoefs, jcolors, jrefl, jlights, jcam), jdir = _jax_pack(
                jscene, perm, n_cubic, row0)(*_jax_args(jscene, jc))
            before = pack_tables.launches
            tables = pack_tables(tscene, tc, host["slots"], n_cubic=n_cubic, row0=row0)
            assert pack_tables.launches == before
            got = dict(zip(_TABLES, (t.numpy() for t in tables)))
            for key, want in (("coefs", jcoefs), ("colors", jcolors), ("refl", jrefl),
                              ("lights", jlights)):
                np.testing.assert_array_equal(got[key], np.asarray(want), err_msg=key)
            np.testing.assert_array_equal(got["orig_index"], np.asarray(perm, np.int32))
            np.testing.assert_array_equal(got["posdef"], np.asarray(posdef, np.int32))
            assert got["cam"][17] == row0
            assert _ulps(got["cam"], np.asarray(jcam)) <= CAMERA_ULPS, pose
            # the largest term of each entry: |monomial(d_li)| * |coef|
            cub = np.abs(coefs32[:, :10]).max(1) * np.abs(lp).max(1)[:, None] ** 3
            quad = np.abs(coefs32[:, 10:16]).max(1) * np.abs(lp).max(1)[:, None] ** 2
            scale = np.where(np.arange(coefs32.shape[0]) < n_cubic, cub, quad)
            tol = DIR_TABLE_TERM_ULPS * np.spacing(scale.astype(np.float32))
            assert got["dir_table"].shape == np.asarray(jdir).shape
            assert (np.abs(got["dir_table"] - np.asarray(jdir)) <= tol).all()


def _seeded_vec(tscene, seed):
    n = acc_layout(tscene.n_objects, tscene.n_lights)[-1]
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(n).astype(np.float32))


def _assert_grads(got, want, label):
    """Table gradients bit for bit; tan_half_fov's, the position's and the
    angles' within CAMERA_GRAD_RTOL of their largest magnitude."""
    for field, g, w in zip(GRAD_FIELDS, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (label, field)
        if field in ("tan_half_fov", "position", "yaw_deg", "pitch_deg"):
            scale = max(np.abs(w).max(), 1e-30)
            assert np.abs(g - w).max() <= CAMERA_GRAD_RTOL * scale, (label, field, g, w)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{label} {field}")


@pytest.mark.parametrize("name", ["dingdong", "20spheres", "reflection_test"])
def test_pack_vjp_plain_matches_jax_vjp_and_autograd(name):
    """``pack_vjp_plain`` on a seeded gradient vector against ``jax.vjp``
    of the JAX packing (cotangents of coefs, colors, refl, lights and cam:
    the direction-form table gets none) and against torch's autograd
    through ``pack_tables_plain``; each gradient in its tensor's dtype."""
    jscene, tscene = _scenes(name)
    host = kb._host_half(tscene, 3, None, None)
    perm = pb._statics_for(jnp.asarray(np.asarray(jscene.coefs)))[0]
    jc, tc = _cameras(POSES[1])
    vec = _seeded_vec(tscene, 15)
    before = pack_vjp.launches
    got = pack_vjp(vec, host["slots"][0], tscene, tc)
    assert pack_vjp.launches == before
    assert [g.dtype for g in got] == [t.dtype for t in grad_tensors(tscene, tc)]

    parts = split_grad(vec, tscene.n_objects, tscene.n_lights)
    cot = tuple(jnp.asarray(parts[k].numpy()) for k in ("coefs", "colors", "refl", "lights",
                                                         "cam"))
    pack = _jax_pack(jscene, perm, host["n_cubic"], 0)
    _, vjp = jax.vjp(lambda *a: pack(*a)[0], *_jax_args(jscene, jc))
    _assert_grads(got, vjp(cot), f"{name} vs jax.vjp")

    leaves = [t.detach().clone().requires_grad_() for t in grad_tensors(tscene, tc)]
    scene, cam = kb._with_tensors(tscene, leaves)
    tables = pack_tables_plain(scene, cam, host["slots"], n_cubic=host["n_cubic"], row0=0)
    outs = [tables[i] for i in (0, 2, 3, 4, 7)]
    want = torch.autograd.grad(outs, leaves, [parts[k] for k in ("coefs", "colors", "refl",
                                                                  "lights", "cam")])
    _assert_grads(got, want, f"{name} vs autograd")


def _frame_grads(scene, cam, fields, packed_render):
    """Gradients of a weighted 32x16 frame for ``fields`` (the rest no
    leaves): through ``render_rows_kernel`` (``FrameRender``) or through
    ``PackedRender`` with autograd through the plain packing."""
    names = GRAD_FIELDS
    leaves = [t.detach().clone().requires_grad_(n in fields)
              for n, t in zip(names, grad_tensors(scene, cam))]
    s, c = kb._with_tensors(scene, leaves)
    w = torch.linspace(0.1, 1.0, scene.height * scene.width * 3).reshape(scene.height,
                                                                         scene.width, 3)
    if packed_render:
        tables, kw = kb.pack_frame(s, c, 0, scene.height)
        image = kb.PackedRender.apply(*tables, kw)
    else:
        image = kb.render_rows_kernel(s, c, 0, scene.height)
    (w * image).sum().backward()
    return {n: t.grad for n, t in zip(names, leaves) if n in fields}


@pytest.mark.parametrize("name", ["dingdong", "reflection_test"])
def test_frame_render_matches_packed_render(name):
    """The frame through ``FrameRender`` at 32x16 against the earlier path
    (``PackedRender``, autograd through the packing), every tensor a leaf:
    the table gradients (coefs, colors, reflection, light_p, light_color,
    bg_color) bit for bit, tan_half_fov's and the camera's within
    CAMERA_GRAD_RTOL; with one leaf, only that leaf gets a gradient."""
    scene = dataclasses.replace(ttt.load_from_file(scene_path(name), device="cpu"),
                                width=32, height=16)
    _, cam = _cameras(POSES[1])
    fields = set(GRAD_FIELDS)
    got = _frame_grads(scene, cam, fields, packed_render=False)
    want = _frame_grads(scene, cam, fields, packed_render=True)
    _assert_grads([got[f] for f in GRAD_FIELDS], [want[f] for f in GRAD_FIELDS], name)
    assert all(got[f].dtype == want[f].dtype for f in GRAD_FIELDS)
    only = _frame_grads(scene, cam, {"light_color"}, packed_render=False)
    assert set(only) == {"light_color"} and torch.equal(only["light_color"], got["light_color"])


def test_wrappers_refuse_other_devices():
    """A wrapper runs its kernel on CUDA tensors, its plain version on CPU
    tensors, and raises on any other device."""
    scene = ttt.load_from_file(scene_path("dingdong"), device="cpu")
    cam = ttt.Camera.initial(torch.float32, "cpu")
    slots = kb._slot_tables(scene.coefs)
    meta = scene.to("meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        pack_tables(meta, cam, slots, n_cubic=1, row0=0)
    vec = torch.zeros(acc_layout(3, scene.n_lights)[-1], device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        pack_vjp(vec, slots[0], meta, cam)
    assert pack_vjp_plain(torch.zeros(vec.shape), slots[0], scene, cam,
                          wanted=[False] * len(GRAD_FIELDS)) == [None] * len(GRAD_FIELDS)
