"""The full-frame gradient gap of dingdong 1280x720 at pitch 5 (ROADMAP
Queue 3), attributed on the CPU.

Over the whole frame, the port pipeline's gradient is outside
tests/test_pallas.py:174-181's rule against K2's in five groups (coefs,
tan_half_fov, position, yaw, pitch; ``chip_smoke.py`` 8d). This test takes
the gradient of sum(w * image), w the cotangent of 8d, four ways, each
summed over row blocks (exact: the loss is a sum over pixels):

* J: ``jax.grad`` of the JAX package's XLA pipeline (f32, polish 3) on row
  slices of its full-frame directions, what ``_render_image_jit`` computes;
* Jy: the same with the yaw one f32 ulp (7.6e-6 degrees) larger;
* Jp: the same fed the port's ray directions (they differ from the JAX
  package's by up to 1.8e-7 on this frame): no gradient reaches the yaw,
  the pitch or the field of view, the position's reaches the origins;
* P: the port's pipeline (``render_rays``) on the same slices.

It holds the finding: the port is outside the rule against J in exactly the
groups where J itself moves outside the rule when the yaw moves by one ulp,
and the light and colour groups stay inside for every pair. The gap is the
f32 conditioning of the near-double-root pixels, whose implicit-function
gradient divides by a dF/dt near 0, not a fault of the port's solve: on the
port's rays, the port's f32 primary hits and the JAX package's are about
as often off the f64 hit (another object, or t beyond 1e-4 relative).

A full-size run (~2.5 min on 6 CPU threads, under 2 GiB), so it is marked
slow; ``python -m pytest tests/test_torch_grad_frame.py -m slow -s`` prints
the four comparisons.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_ray_tracer as trt
import tpu_ray_tracer_torch as ttt
from tpu_ray_tracer.ops import camera as jcam
from tpu_ray_tracer.ops.intersect import intersect_all as jax_intersect_all
from tpu_ray_tracer.render import pipeline as jpipe
from tpu_ray_tracer_torch.ops import camera as tcam
from tpu_ray_tracer_torch.ops.intersect import intersect_all
from tpu_ray_tracer_torch.render import pipeline as tpipe

from conftest import scene_path
from test_torch_grad import to_torch

ROWS = 72
SCENE_GROUPS = ("coefs", "light_color", "light_p", "colors", "bg_color", "tan_half_fov")
CAMERA_GROUPS = ("position", "yaw_deg", "pitch_deg")
GROUPS = SCENE_GROUPS + CAMERA_GROUPS
POSE = ((0.0, 0.0, 0.0), 90.0, 5.0)
SMOOTH = ("light_color", "light_p", "colors", "bg_color")


def primary(t):
    """(object, t) of the nearest valid root per ray, (-1, 0) for a miss."""
    valid = (t >= 1e-7) & (t < 1e6)
    masked = np.where(valid, t, np.inf)
    hit = valid.any(-1)
    return np.where(hit, masked.argmin(-1), -1), np.where(hit, masked.min(-1), 0.0)


def off(got, ref):
    """Rays whose primary hit is another object or t beyond 1e-4 relative."""
    return (got[0] != ref[0]) | ((ref[0] >= 0) & (np.abs(got[1] - ref[1]) > 1e-4 * np.abs(ref[1])))


def rule(got, ref):
    """(relative error, limit) of tests/test_pallas.py:174-181."""
    scale = max(np.abs(ref).max(), 1e-6)
    return float(np.abs(got - ref).max() / scale), (2e-3 if np.abs(ref).max() > 1.0 else 2e-2)


@pytest.mark.slow
def test_full_frame_gap_is_the_references_own_conditioning():
    jscene = trt.load_from_file(scene_path("dingdong"))
    height, width = jscene.height, jscene.width
    w = torch.linspace(0.1, 1.0, height * width * 3, dtype=torch.float32).reshape(
        height, width, 3).numpy()
    s32 = jax.tree.map(jnp.asarray, jscene.astype(jnp.float32))
    yaw_ulp = float(np.spacing(np.float32(POSE[1])))

    def make_grad(variant):
        def block_loss(vals, w_block, y0, port_dirs):
            s = dataclasses.replace(s32, **{k: vals[k] for k in SCENE_GROUPS})
            yaw = vals["yaw_deg"] + (yaw_ulp if variant == "Jy" else 0.0)
            cam = trt.Camera(position=vals["position"], yaw_deg=yaw, pitch_deg=vals["pitch_deg"])
            rot, eye = jcam.camera_frame(cam)
            dirs = jcam.pixel_directions(rot, width, height, s.aspect_ratio, s.tan_half_fov)
            d = jax.lax.dynamic_slice_in_dim(dirs, y0, ROWS, axis=0).reshape(-1, 3)
            if variant == "Jp":
                d = port_dirs
            img = jpipe.render_rays(s, jnp.broadcast_to(eye, d.shape), d, polish_iters=3,
                                    bounces=0)
            return jnp.sum(w_block * img.reshape(ROWS, width, 3))
        return jax.jit(jax.grad(block_loss))

    jvals = {**{k: getattr(s32, k) for k in SCENE_GROUPS},
             "position": jnp.asarray(POSE[0], jnp.float32),
             "yaw_deg": jnp.asarray(POSE[1], jnp.float32),
             "pitch_deg": jnp.asarray(POSE[2], jnp.float32)}
    grad_fns = {v: make_grad(v) for v in ("J", "Jy", "Jp")}
    t32 = to_torch(jscene).astype(torch.float32)
    leaves = {k: getattr(t32, k).clone().requires_grad_() for k in SCENE_GROUPS}
    cam_leaves = {k: torch.tensor(v, dtype=torch.float32, requires_grad=True)
                  for k, v in zip(CAMERA_GROUPS, POSE)}
    acc = {v: {k: 0.0 for k in GROUPS} for v in ("J", "Jy", "Jp", "P")}
    jax_roots = jax.jit(jax_intersect_all, static_argnums=3)
    n_off = {"port": 0, "jax": 0, "apart": 0}
    for y0 in range(0, height, ROWS):
        w_block = w[y0:y0 + ROWS]
        scene = dataclasses.replace(t32, **leaves)
        rot, eye = tcam.camera_frame(ttt.Camera(**cam_leaves))
        dirs = tcam.pixel_directions(rot, width, height, scene.aspect_ratio,
                                     scene.tan_half_fov)[y0:y0 + ROWS].reshape(-1, 3)
        for variant, fn in grad_fns.items():
            g = fn(jvals, jnp.asarray(w_block), y0, jnp.asarray(dirs.detach().numpy()))
            for k in GROUPS:
                acc[variant][k] = acc[variant][k] + np.asarray(g[k], np.float64)
        with torch.no_grad():
            d, o = dirs.detach(), eye.detach().expand(dirs.shape)
            hits = {"port": primary(intersect_all(t32.coefs, o, d, 3).numpy()),
                    "jax": primary(np.asarray(jax_roots(s32.coefs, jnp.asarray(o.numpy()),
                                                        jnp.asarray(d.numpy()), 3))),
                    "f64": primary(intersect_all(to_torch(jscene).coefs, o.double(),
                                                 d.double(), 0).numpy())}
        n_off["port"] += int(off(hits["port"], hits["f64"]).sum())
        n_off["jax"] += int(off(hits["jax"], hits["f64"]).sum())
        n_off["apart"] += int(off(hits["port"], hits["jax"]).sum())
        img = tpipe.render_rays(scene, eye.expand(dirs.shape), dirs, polish_iters=3, bounces=0)
        (torch.from_numpy(w_block) * img.reshape(ROWS, width, 3)).sum().backward()
        for k, leaf in {**leaves, **cam_leaves}.items():
            acc["P"][k] = acc["P"][k] + leaf.grad.double().numpy()
            leaf.grad = None

    out = {}
    for a, b in (("P", "J"), ("Jy", "J"), ("Jp", "J"), ("P", "Jp")):
        groups = (*SCENE_GROUPS[:-1], "position") if "Jp" in (a, b) else GROUPS
        out[a, b] = {k: rule(acc[a][k], acc[b][k]) for k in groups}
        print(f"{a} vs {b}: " + ", ".join(f"{k} {r:.4g}{'' if r < tol else ' (outside)'}"
                                          for k, (r, tol) in out[a, b].items()))
    print(f"primary hits on the port's rays: port f32 off f64 on {n_off['port']}, JAX f32 on "
          f"{n_off['jax']}, port and JAX apart on {n_off['apart']} of {height * width}")
    assert n_off["port"] <= 1.05 * n_off["jax"], n_off
    outside = {pair: {k for k, (r, tol) in res.items() if r >= tol} for pair, res in out.items()}
    assert outside["P", "J"], "the gap is closed: update ROADMAP Queue 3"
    assert outside["P", "J"] <= outside["Jy", "J"], outside
    for res in out.values():
        assert all(res[k][0] < res[k][1] for k in SMOOTH), res
