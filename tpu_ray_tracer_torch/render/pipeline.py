"""The plain PyTorch render pipeline: trace -> shade -> reflect, vectorized
over rays.

Counterpart of ``tpu_ray_tracer/render/pipeline.py`` (the JAX package's XLA
pipeline). The per-pixel program of the reference's serial CPU loop
(reference: src/update-cpu.cpp:45-119) is written once over a flat ray batch
with tensor operations; it runs wherever its tensors are, the CPU or the
card, and autograd differentiates it.

Structure per ray (reference: update-cpu.cpp:82-119):

1. primary trace: nearest object with EPS <= t < MAX_T (first index wins
   ties, matching the reference's strict-< scan; ``torch.argmin`` returns
   the first minimum, as ``jnp.argmin`` does);
2. shading: per light, shadow ray from ``point + SHADOW_BIAS*normal``,
   occluded iff any object has EPS < t < max_t; sum unshadowed Lambertian
   contributions, clamp each channel to <= 1;
3. reflection chain with the reference's cumulative-ratio blend
   ``result = (1 - cur_ratio)*result + cur_ratio*new`` (update-cpu.cpp:97-117),
   a masked loop: every lane advances in lockstep, with an active mask
   replacing ``break``.

The per-ray gathers of per-object rows (coefficients, colours, reflection
ratios) go through ``select_kernel.select_rows``: ``table[idx]``, whose
gradient on the card is summed by a deterministic kernel.

Visibility booleans are non-differentiable by construction (comparisons),
and the occlusion solve runs on detached tensors, so the backward pass skips
it entirely. Eager torch materialises every intermediate that XLA would
fuse: ``RenderConfig.chunk_px`` bounds them by rendering the frame in
sequential chunks of rays (a shadow solve is [rays, lights, objects]).

On the card a frame without a recorded gradient replays a CUDA graph of
``_render_image`` (``render/graphs.py``), the counterpart of the JAX
package's ``_render_image_jit``: its key is the config and the tables'
shapes, dtypes and devices, and a frame whose warm-up holds more than
``graphs.MAX_GRAPH_BYTES`` stays eager.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..models.scene import _TENSOR_FIELDS, Scene, static_bounce_count
from ..ops import camera as camera_ops
from ..ops.constants import EPS, MAX_T, SHADOW_BIAS
from ..ops.intersect import intersect_all, occluder_mask, valid_hit_mask
from ..ops.poly import normal_vector
from ..ops.shading import reflect_ray, shadow_ray_dirs, surface_color
from . import graphs
from .select_kernel import select_rows


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render-path configuration.

    geom_dtype: geometry precision. float64 = golden path (parity oracle),
      float32 = fast path.
    polish_iters: Newton refinement steps for the f32 path (0 for f64).
    bounces: reflection-chain trip count; None derives it from the scene
      (0 when no object is reflective, else scene.max_reflections).
    chunk_px: rays per sequential chunk to bound [rays, lights, objects]
      intermediates; None renders in one shot.
    """

    geom_dtype: str = "float32"
    polish_iters: int = 2
    bounces: int | None = None
    chunk_px: int | None = 65536

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.geom_dtype)


GOLDEN_CONFIG = RenderConfig(geom_dtype="float64", polish_iters=0, chunk_px=65536)
FAST_CONFIG = RenderConfig(geom_dtype="float32", polish_iters=3, chunk_px=None)


class TraceResult(NamedTuple):
    hit: torch.Tensor        # [...] bool
    idx: torch.Tensor        # [...] int64 (0 where ~hit)
    point: torch.Tensor      # [..., 3]
    normal: torch.Tensor     # [..., 3]
    lit_color: torch.Tensor  # [..., 3] f32, shadow-tested + clamped


def trace_and_shade(scene: Scene, origin, dir, polish_iters: int) -> TraceResult:
    """Nearest-hit + lighting, the analogue of reference
    ``get_color_and_object`` (src/update-cpu.cpp:45-80)."""
    return shade_roots(scene, origin, dir,
                       intersect_all(scene.coefs, origin, dir, polish_iters), polish_iters)


def shade_roots(scene: Scene, origin, dir, t_all, polish_iters: int) -> TraceResult:
    """``trace_and_shade`` given the per-object root table ``t_all``
    [..., N]: the nearest valid root, its normal and its shadow-tested
    lighting (the soft render shades two root tables with it)."""
    valid = valid_hit_mask(t_all)
    hit = valid.any(-1)
    t_masked = torch.where(valid, t_all, torch.full_like(t_all, MAX_T))
    idx = torch.argmin(t_masked, dim=-1)
    best_t = torch.gather(t_all, -1, idx[..., None])[..., 0]
    # Freeze miss lanes at t=0 so downstream math stays finite.
    best_t = torch.where(hit, best_t, torch.zeros_like(best_t))

    point = origin + best_t[..., None] * dir
    sel_coefs = select_rows(scene.coefs, idx)                        # [..., 20]
    normal = normal_vector(sel_coefs, point)
    obj_color = select_rows(scene.colors, idx)                       # [..., 3]

    # Shadows: occlusion is non-differentiable visibility; detaching its
    # inputs prunes the (expensive) backward intersect entirely.
    shadow_origin = point + SHADOW_BIAS * normal
    sdir, max_t = shadow_ray_dirs(scene.light_p, scene.light_is_spherical, point)
    occ_t = intersect_all(
        scene.coefs.detach(),
        shadow_origin.detach()[..., None, :],
        sdir.detach(),
        polish_iters,
    )                                                                # [..., L, N]
    in_shadow = occluder_mask(occ_t, max_t[..., None]).any(-1)

    contrib = surface_color(
        scene.light_p, scene.light_is_spherical, scene.light_color,
        point, normal, obj_color,
    )                                                                # [..., L, 3]
    lit = torch.where(in_shadow[..., None], torch.zeros_like(contrib), contrib).sum(-2)
    lit = torch.minimum(torch.ones((), dtype=lit.dtype, device=lit.device), lit)
    return TraceResult(hit=hit, idx=idx, point=point, normal=normal, lit_color=lit)


def _blend(result, color, ratio):
    """Cumulative-ratio reflection blend (reference: update-cpu.cpp:96)."""
    r = ratio[..., None]
    return (1.0 - r) * result + r * color


def render_rays(scene: Scene, origin, dir, *, polish_iters: int, bounces: int):
    """Full per-ray pipeline -> [..., 3] f32 colors.

    `bounces` is the number of *traced* reflection iterations
    (scene.max_reflections when any object is reflective, else 0); the
    reference's at-cap background blend (update-cpu.cpp:98-101) is applied
    after the loop.
    """
    bg = scene.bg_color.to(torch.float32)
    if scene.n_objects == 0:
        # Every ray misses (legal input: the reference tolerates an empty
        # objects sequence, src/scene.cpp:169-170); argmin over a zero-size
        # object axis would fail, so short-circuit to the background —
        # differentiably w.r.t. bg_color, with no gradient to the (empty)
        # object tables and lights.
        return bg.expand(origin.shape[:-1] + (3,))
    res = trace_and_shade(scene, origin, dir, polish_iters)
    result = torch.where(res.hit[..., None], res.lit_color, bg)
    if bounces == 0:
        return result

    refl = scene.reflection
    ratio = torch.ones(res.hit.shape, dtype=torch.float32, device=res.hit.device)
    active, idx, point, normal, cur_dir = res.hit, res.idx, res.point, res.normal, dir
    for _ in range(bounces):
        r = select_rows(refl, idx)
        enter = active & (r > EPS)
        ratio = torch.where(enter, ratio * r, ratio)

        new_dir = reflect_ray(cur_dir, normal)
        new_origin = point + SHADOW_BIAS * normal
        nxt = trace_and_shade(scene, new_origin, new_dir, polish_iters)

        bounce_color = torch.where(nxt.hit[..., None], nxt.lit_color, bg)
        result = torch.where(enter[..., None], _blend(result, bounce_color, ratio), result)

        advanced = enter & nxt.hit
        idx = torch.where(advanced, nxt.idx, idx)
        point = torch.where(advanced[..., None], nxt.point, point)
        normal = torch.where(advanced[..., None], nxt.normal, normal)
        cur_dir = torch.where(enter[..., None], new_dir, cur_dir)
        active = advanced

    # At-cap blend: lanes still wanting to reflect absorb the background
    # (reference: update-cpu.cpp:98-101).
    r = select_rows(refl, idx)
    enter = active & (r > EPS)
    return torch.where(enter[..., None], _blend(result, bg, ratio * r), result)


def resolve_bounces(scene: Scene, config: RenderConfig) -> int:
    if config.bounces is not None:
        return config.bounces
    return static_bounce_count(scene)


def _render_image(scene: Scene, camera: camera_ops.Camera, config: RenderConfig):
    """The frame at ``config`` with ``config.bounces`` traced bounces (None
    reads as 0): the body of the JAX package's ``_render_image_jit``."""
    dtype = config.dtype
    scene = scene.astype(dtype)
    camera = camera.to(dtype, scene.coefs.device)
    bounces = config.bounces if config.bounces is not None else 0

    rotation, eye = camera_ops.camera_frame(camera)
    dirs = camera_ops.pixel_directions(
        rotation, scene.width, scene.height, scene.aspect_ratio, scene.tan_half_fov
    )                                                            # [H, W, 3]
    height, width = scene.height, scene.width
    n_px = height * width
    flat_dirs = dirs.reshape(n_px, 3)

    def run(d):
        return render_rays(scene, eye.expand(d.shape), d,
                           polish_iters=config.polish_iters, bounces=bounces)

    chunk = config.chunk_px
    if chunk is None or chunk >= n_px:
        colors = run(flat_dirs)
    else:
        colors = torch.cat([run(flat_dirs[i:i + chunk]) for i in range(0, n_px, chunk)])
    return colors.reshape(height, width, 3)


def _frame_tensors(scene: Scene, camera: camera_ops.Camera) -> list:
    """Every tensor a frame reads: the scene's tables, then the camera's."""
    return ([getattr(scene, f) for f in _TENSOR_FIELDS]
            + [camera.position, camera.yaw_deg, camera.pitch_deg])


def _with_frame_tensors(scene: Scene, tensors) -> tuple:
    """(scene, camera) made of ``_frame_tensors``' list."""
    n = len(_TENSOR_FIELDS)
    return (dataclasses.replace(scene, **dict(zip(_TENSOR_FIELDS, tensors[:n]))),
            camera_ops.Camera(*tensors[n:]))


# The pipeline frames' graphs, by key.
_FRAMES = graphs.GraphCache()


def render_image(scene: Scene, camera: camera_ops.Camera | None = None,
                 config: RenderConfig = FAST_CONFIG):
    """Render the full frame -> [H, W, 3] f32 on the scene's device, row 0 =
    bottom (GL convention); differentiable in the scene's and camera's
    tensors.

    The analogue of one reference ``update()`` call (src/update-cpu.cpp:121-139),
    minus the GL upload: the framebuffer is returned as a tensor.

    On CUDA tables, when autograd records nothing (grad mode off, or no
    table requiring grad), the frame replays the CUDA graph of its key, as
    the JAX entry launches the executable of ``_render_image_jit``: the
    config (dtype, polish, bounces, ``chunk_px``), the image's size and the
    tables' shapes, dtypes and devices. The key's first call runs eagerly,
    its second captures, and the frame returned is a fresh tensor. A frame
    with a gradient, on CPU tables, inside ``graphs.eager()`` or whose
    warm-up held more than ``graphs.MAX_GRAPH_BYTES`` runs eagerly.
    """
    device = scene.coefs.device
    if camera is None:
        camera = camera_ops.Camera.initial(config.dtype, device)
    if config.bounces is None:
        # Specialize the reflection trip count on the concrete scene (host-side).
        config = dataclasses.replace(config, bounces=resolve_bounces(scene, config))
    tensors = _frame_tensors(scene, camera)
    if (not graphs.active(device) or any(t.device != device for t in tensors)
            or (torch.is_grad_enabled() and any(t.requires_grad for t in tensors))):
        return _render_image(scene, camera, config)
    key = (config, scene.width, scene.height, graphs.signature(tensors))

    def body(*inputs):
        return _render_image(*_with_frame_tensors(scene, inputs), config)

    return _FRAMES.run(key, device, lambda: graphs.Graph(device, body, tensors),
                       lambda: body(*tensors), tensors)
