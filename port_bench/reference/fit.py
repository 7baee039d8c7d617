"""The benchmark's plain reference of a frame and of a fit's first steps.

Everything here runs the frozen plain pipeline of this package (eager torch,
no kernel, no CUDA graph) on tables it loads itself from the configuration's
YAML file: it reads nothing the program made.

* ``load_scene``: the scene as ``models/loader.py`` parses it, cast to one
  dtype (geometry and colours alike: float64 for the reference, bfloat16 for
  the control that stands in the program's place).
* ``render_frame``: the whole frame at one pose.
* ``fit_steps``: the first steps of the fit that ``diff/inverse.py`` of the
  port runs: the perturbed fields as leaves, the loss (the sum of squared
  errors over the frame divided by ``H * W * 3``, computed and
  differentiated one row block at a time, as the port's ``Loss`` does on its
  pipeline route), Adam (``torch.optim.Adam``, betas 0.9 and 0.999, eps
  1e-8). Where the problem has a temperature the render is ``soft.py``'s,
  which shares no code with the frozen pipeline: the program renders a soft
  fit with the port's own pipeline, of which that pipeline is a copy.
"""

from __future__ import annotations

import dataclasses

import torch

from . import soft
from .models.loader import load_from_file
from .models.scene import Scene
from .ops import camera as camera_ops
from .render.pipeline import RenderConfig, render_image, render_rays

# [rays x lights+1 x objects] elements of one row block in float32 (the
# port's ``_BLOCK_ELEMENTS``); fewer in wider dtypes
BLOCK_ELEMENTS_F32 = 1 << 22
ADAM_BETA1 = 0.9


def load_scene(path, device, dtype) -> Scene:
    scene = load_from_file(path, device=device)
    return scene.astype(dtype, dtype)


def perturb(scene: Scene, factors: dict) -> Scene:
    """Scale each field by its factor, as ``cli._perturb_scene`` of the port
    does: ``coefs`` only in its constant column (a uniform scaling of a row
    leaves the zero set unchanged), any other field whole."""
    updates = {}
    for field, factor in factors.items():
        value = getattr(scene, field)
        if field == "coefs":
            value = value.clone()
            value[:, 19] = value[:, 19] * factor
        else:
            value = value * factor
        updates[field] = value
    return dataclasses.replace(scene, **updates)


def camera(dtype, device, position=(0.0, 0.0, 0.0), yaw_deg=90.0, pitch_deg=0.0):
    return camera_ops.Camera(position=torch.tensor(position, dtype=dtype, device=device),
                             yaw_deg=torch.tensor(yaw_deg, dtype=dtype, device=device),
                             pitch_deg=torch.tensor(pitch_deg, dtype=dtype, device=device))


def render_frame(scene: Scene, cam, *, polish_iters: int, chunk_px: int = 65536):
    """[H, W, 3] of the whole frame in the scene's dtype, without a gradient."""
    config = RenderConfig(geom_dtype=str(scene.coefs.dtype).removeprefix("torch."),
                          polish_iters=polish_iters, chunk_px=chunk_px)
    with torch.no_grad():
        return render_image(scene, cam, config)


def block_rows(scene: Scene, soft: bool) -> int:
    per_ray = max(scene.n_objects, 1) * (scene.n_lights + 1) * (2 if soft else 1)
    elements = BLOCK_ELEMENTS_F32 * 4 // max(scene.coefs.element_size(), 4)
    return max(1, min(scene.height, elements // (per_ray * scene.width)))


def loss_backward(scene: Scene, params: dict, cam, target, *, polish_iters: int, tau=None,
                  pair_kinds=None, rows: int | None = None):
    """The loss of rows [0, rows) (all rows by default), its gradient added
    into the parameters' ``.grad`` one row block at a time; returns the loss
    as a float. With ``rows`` short of the height the mean is over those rows
    alone."""
    scene = dataclasses.replace(scene, **params)
    height = scene.height if rows is None else rows
    n = height * scene.width * 3
    rotation, eye = camera_ops.camera_frame(cam)
    step = block_rows(scene, tau is not None)
    total = 0.0
    for y0 in range(0, height, step):
        r = min(step, height - y0)
        if tau is None:
            dirs = camera_ops.pixel_directions(rotation, scene.width, scene.height,
                                               scene.aspect_ratio, scene.tan_half_fov, y0=y0,
                                               rows=r)
            img = render_rays(scene, eye.expand(dirs.shape), dirs, polish_iters=polish_iters,
                              bounces=0)
        else:
            origin, dirs = soft.rays(scene, cam.position.tolist(), float(cam.yaw_deg),
                                     float(cam.pitch_deg), y0, r)
            img = soft.render_soft(scene, origin, dirs, tau, pair_kinds).reshape(r, -1, 3)
        err = img - target[y0:y0 + r].to(img.dtype)
        loss = (err * err).sum() / n
        loss.backward()
        total += float(loss.detach())
    return total


def fit_steps(template: Scene, fields, target, *, steps: int, lr: float, polish_iters: int,
              taus=None, rows: int | None = None) -> dict:
    """The first ``steps`` steps of the fit from ``template`` (already
    perturbed, in the dtype to compute in): {"losses": [float], "grad1":
    {field: the first gradient as Adam holds it}, "change": {field: the
    parameters after the steps less those before}}. ``taus`` holds each
    step's temperature (a soft loss), else None."""
    params = {f: getattr(template, f).detach().clone().requires_grad_() for f in fields}
    start = {f: p.detach().clone() for f, p in params.items()}
    opt = torch.optim.Adam(list(params.values()), lr=lr)
    cam = camera(template.coefs.dtype, template.coefs.device)
    pair_kinds = (template.coefs[:, :10].abs() > 0).any(1) if taus is not None else None
    losses, grad1 = [], None
    for k in range(steps):
        opt.zero_grad(set_to_none=True)
        losses.append(loss_backward(template, params, cam, target, polish_iters=polish_iters,
                                    tau=None if taus is None else taus[k],
                                    pair_kinds=pair_kinds, rows=rows))
        opt.step()
        if k == 0:
            grad1 = {f: (opt.state[p]["exp_avg"] / (1 - ADAM_BETA1)).detach().clone()
                     for f, p in params.items()}
    return {"losses": losses, "grad1": grad1,
            "change": {f: (params[f].detach() - start[f]) for f in fields}}
