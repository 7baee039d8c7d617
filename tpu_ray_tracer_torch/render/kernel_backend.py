"""Host half of the kernel path: scene statics, table packing and the public
render entries.

Counterpart of the host-side code of
``tpu_ray_tracer/render/pallas_backend.py`` (``render_image_pallas`` :2259,
``render_rows_pallas`` :2158, ``_render_pallas_raw`` :1336,
``_render_pallas_jit`` :1457, and the ``custom_vjp`` pair ``_packed_render``
/ ``_packed_fwd`` / ``_packed_bwd`` :2032-2120). A frame is: the scene
statics (cubics-first slot order, per-slot posdef, whether the chain runs),
memoised per table; the packed tables (``pack_kernel.pack_tables``: one
launch on the card, the counterpart of what XLA fuses around the Pallas
call); one ``render_fwd`` launch.

The render is differentiable. When grad mode is on and a scene or camera
tensor requires grad, the frame goes through ``FrameRender``: the forward
packs the tables and saves its per-stage aux (``render_fwd(...,
save_aux=True)``), and the backward is one ``render_bwd`` call on it and
one ``pack_vjp`` call, which takes the gradient rows back through the
packing (the slot gather, the f32 casts and the camera frame) to the
scene's and camera's own tensors, as ``jax.grad`` carries them through
``jnp.take``, ``_pack_lights`` and ``_pack_camera``. Autograd records no
torch op of the packing. ``PackedRender`` is the same render for a caller
that holds packed tables.

The fused backward encodes a scene with at least one object and at most 31
lights (the i32 occlusion mask). A gradient of any other scene goes through
``PipelineGradRender``, the counterpart of ``_render_pallas_diff`` /
``_diff_fwd`` / ``_diff_bwd`` (:2123-2155): one ``render_fwd`` launch
without aux forward, and the backward recomputed through the plain pipeline
(``render/pipeline.py``).

The JAX package's scene statics are jit-static and its kernel is rebuilt
per scene; here they are runtime arguments of one kernel build, and the
light kinds are read by the kernel from column 0 of the light table.

Where the JAX package launches one jitted executable per frame, a frame on
the card replays one CUDA graph (``render/graphs.py``): the packing and the
launch, captured for the frame's key (the statics, the iteration counts,
the rows, the tables' shapes and which of them require grad); a
differentiable frame replays a forward graph and, in its backward, a
backward graph; so does ``PipelineGradRender``, whose backward graph holds
the pipeline's recompute. ``pack_frame`` is split for it into a host half
(``_host_half``: the statics and slot tables, memoised) and ``_pack``,
device operations only.

While a torch profiler runs, a frame shows as the span ``trt.frame``, its
host half and key as ``trt.frame.key``, a memo miss as ``trt.memo``, and
the graphs' steps as ``render/graphs.py``'s spans.
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from ..models.scene import Scene
from ..ops import camera as camera_ops
from ..utils.timing import span
from . import graphs, pipeline
from .bwd_kernel import render_bwd, split_grad
from .fwd_kernel import MAX_AUX_LIGHTS, QUAD_START, render_fwd
from .pack_kernel import SCENE_GRAD_FIELDS, grad_tensors, pack_tables, pack_vjp

# Numerics knobs of the Pallas kernel, fixed at their defaults there:
# `_shadow_polish_default()` (:1235) and `_screen_iters_default()` (:1240).
SHADOW_POLISH = 1
SCREEN_ITERS = 3


def _degree_partition(coefs):
    """Cubics-first permutation (perm, n_cubic) from concrete coefficients.

    perm lists original object indices, cubic objects first, stable within
    each class. An object is cubic iff any of its 10 cubic coefficients is
    nonzero; otherwise t3 == 0 along every ray and only the reference's
    quadratic/linear branches can fire, so the partition keeps semantics."""
    cc = np.asarray(coefs)
    is_cubic = (np.abs(cc[:, :QUAD_START]) > 0).any(axis=1)
    perm = np.argsort(~is_cubic, kind="stable").astype(np.int32)
    return perm, int(is_cubic.sum())


def _quad_posdef(coefs):
    """Per-object positive definiteness of the quadratic form Q (Sylvester's
    criterion; every sphere qualifies). A True entry selects the specialised
    occlusion classifier for that (quadric) slot. Columns 10-15 hold
    x2, y2, z2, xy, xz, yz."""
    cc = np.asarray(coefs, np.float64)
    a, b, c = cc[:, 10], cc[:, 11], cc[:, 12]
    d, e, f = cc[:, 13] / 2, cc[:, 14] / 2, cc[:, 15] / 2
    m2 = a * b - d * d
    m3 = (a * (b * c - f * f) - d * (d * c - f * e)
          + e * (d * f - b * e))
    return (a > 0) & (m2 > 0) & (m3 > 0)


# Memo of values derived from a table on the host, so that a frame loop does
# not copy the table to the host (and wait for the device) every frame. The
# key holds the tensor's data pointer, shape, dtype, device and version
# counter, which every in-place torch op bumps (the JAX memo could key on
# identity alone because JAX arrays are immutable); the weakref rejects an
# entry whose tensor died and whose id and address were reused. Writes that
# bypass autograd's version counter (through ``.data`` or a shared numpy
# buffer) are not seen.
_MEMO: dict = {}


def _memo(t: torch.Tensor, fn):
    """``fn(t)``, memoised; a CUDA graph being captured holds the value (the
    memo may drop it while the graph still reads it, ``graphs.hold``)."""
    key = (fn.__name__, id(t), t.data_ptr(), t._version, tuple(t.shape), t.dtype,
           t.device)
    entry = _MEMO.get(key)
    if entry is not None and entry[0]() is t:
        return graphs.hold(entry[1])
    with span("trt.memo"):
        value = fn(t)
    if len(_MEMO) > 64:
        _MEMO.clear()
    _MEMO[key] = (weakref.ref(t), value)
    return graphs.hold(value)


def _compute_statics(coefs: torch.Tensor):
    cc = coefs.detach().cpu().numpy()
    perm, n_cubic = _degree_partition(cc)
    pd = _quad_posdef(cc)
    return (tuple(int(i) for i in perm), n_cubic, tuple(bool(pd[i]) for i in perm))


def _statics_for(coefs: torch.Tensor):
    """(perm, n_cubic, posdef) for a coefficient table, memoised; ``posdef``
    is in the permuted slot order the kernel sees."""
    return _memo(coefs, _compute_statics)


def _compute_slot_tables(coefs: torch.Tensor):
    perm, _, posdef = _statics_for(coefs)
    dev = coefs.device
    return (torch.tensor(perm, dtype=torch.int64, device=dev),
            torch.tensor(perm, dtype=torch.int32, device=dev),
            torch.tensor(posdef, dtype=torch.int32, device=dev))


def _slot_tables(coefs: torch.Tensor):
    """(gather index, orig_index, posdef) tensors on the table's device."""
    return _memo(coefs, _compute_slot_tables)


def _reflective(refl: torch.Tensor) -> bool:
    """The entry test of ``static_bounce_count``: any ratio above EPS."""
    return refl.numel() > 0 and float(refl.detach().max()) > 1e-7


def _light_kinds_of(light_is_spherical) -> tuple:
    """Per-light kind tuple (True = spherical)."""
    return tuple(bool(x) for x in torch.as_tensor(light_is_spherical).tolist())


def _iteration_counts(scene: Scene, polish_iters: int, bounces, shadow_iters):
    """(bounces, shadow_iters) of a frame: the reflection chain's length
    (``max_reflections`` when any object reflects, unless given) and the
    shadow solves' Newton steps, clamped to [1, polish_iters]."""
    if bounces is None:
        bounces = scene.max_reflections if _memo(scene.reflection, _reflective) else 0
    if shadow_iters is None:
        shadow_iters = min(SHADOW_POLISH, polish_iters)
    return int(bounces), max(1, min(int(shadow_iters), polish_iters))


def _pack(scene: Scene, camera: camera_ops.Camera, row0: int, rows: int, n_cubic: int,
          slots, polish_iters: int, bounces: int, shadow_iters: int):
    """``pack_frame`` with its host half done: the statics' ``n_cubic`` and
    slot tables (``_slot_tables``) given. Device operations only (one
    ``pack_tables`` launch on the card), so a CUDA graph can capture it."""
    scene, camera = _on_device(scene, camera)
    tables = pack_tables(scene, camera, slots, n_cubic=n_cubic, row0=int(row0))
    kwargs = dict(width=scene.width, height=scene.height, rows=int(rows),
                  n_cubic=n_cubic, polish_iters=int(polish_iters),
                  shadow_iters=shadow_iters, screen_iters=SCREEN_ITERS,
                  bounces=bounces)
    return tables, kwargs


def _on_device(scene: Scene, camera: camera_ops.Camera):
    """(scene, camera) with their differentiable tensors contiguous and the
    camera's on the scene's device, as the packing kernel reads them (no
    copy where they already are)."""
    dev = scene.coefs.device
    return _with_tensors(scene, [t.to(dev).contiguous() for t in grad_tensors(scene, camera)])


def pack_frame(scene: Scene, camera: camera_ops.Camera, row0: int, rows: int,
               *, polish_iters: int = 3, bounces: int | None = None,
               shadow_iters: int | None = None):
    """(tables, keyword arguments) of one ``render_fwd`` call for image rows
    [row0, row0 + rows), on the scene's device."""
    return _pack(scene, camera, row0, rows,
                 **_host_half(scene, polish_iters, bounces, shadow_iters))


class PackedRender(torch.autograd.Function):
    """The differentiable render on packed tables: the forward launches
    ``render_fwd`` with ``save_aux``, the backward one ``render_bwd`` on that
    aux (the counterpart of ``_packed_render`` / ``_packed_fwd`` /
    ``_packed_bwd``).

    Inputs are the 8 tables of ``pack_frame`` and its keyword dict. The
    gradient goes to coefs, colors, refl, lights and cam; ``orig_index``,
    ``posdef`` and ``dir_table`` get none. ``dir_table`` feeds only the
    occlusion tests, which the JAX VJP never differentiates, so a gradient
    through it would be counted twice.
    """

    @staticmethod
    def forward(ctx, coefs, orig_index, colors, refl, lights, dir_table, posdef, cam, kwargs):
        image, *aux = render_fwd(coefs, orig_index, colors, refl, lights, dir_table, posdef,
                                 cam, **kwargs, save_aux=True)
        ctx.save_for_backward(coefs, colors, refl, lights, cam, *aux)
        ctx.kwargs = kwargs
        return image

    @staticmethod
    def backward(ctx, grad_image):
        coefs, colors, refl, lights, cam, *aux = ctx.saved_tensors
        kw = ctx.kwargs
        n_obj, n_lights = coefs.shape[0], lights.shape[0]
        vec = render_bwd(coefs, colors, refl, lights, cam,
                         grad_image.to(torch.float32).contiguous(), *aux,
                         width=kw["width"], height=kw["height"], rows=kw["rows"],
                         n_lights=n_lights, bounces=kw["bounces"])
        grads = split_grad(vec, n_obj, n_lights)
        # cam row 17 is the integer row offset and light column 0 the kind
        # flag: neither is a parameter (Pallas :2099-2109). Filled on the
        # device: an assignment from a Python number copies from the host,
        # which a CUDA graph cannot capture
        grads["cam"].narrow(0, 17, 1).fill_(0.0)
        grads["lights"].narrow(1, 0, 1).fill_(0.0)
        return (grads["coefs"], None, grads["colors"], grads["refl"], grads["lights"], None,
                None, grads["cam"], None)


def _with_tensors(scene: Scene, tensors) -> tuple:
    """(scene, camera) with ``grad_tensors``' tensors replaced."""
    n = len(SCENE_GRAD_FIELDS)
    return (dataclasses.replace(scene, **dict(zip(SCENE_GRAD_FIELDS, tensors[:n]))),
            camera_ops.Camera(*tensors[n:]))


def _wants_grad(scene: Scene, camera: camera_ops.Camera) -> bool:
    """Whether autograd would record the render: grad mode on and any
    differentiable scene or camera tensor requiring grad."""
    return torch.is_grad_enabled() and any(t.requires_grad
                                           for t in grad_tensors(scene, camera))


def _fused_backward_encodes(scene: Scene) -> bool:
    """At least one object and at most 31 lights (the i32 occlusion mask)."""
    return scene.n_objects > 0 and scene.n_lights <= MAX_AUX_LIGHTS


class FrameRender(torch.autograd.Function):
    """The differentiable frame from the scene's and camera's own tensors:
    the forward is ``pack_tables`` and ``render_fwd`` with ``save_aux``, the
    backward one ``render_bwd`` on that aux and one ``pack_vjp``, which
    takes the tables' gradient rows back to the tensors (the counterpart of
    ``_render_pallas_jit``'s packing and ``_packed_render``'s VJP, which
    ``jax.grad`` fuses).

    Inputs: the scene (its differentiable tensors are replaced by the last
    ones), the frame's host half (``_host_half``), the rows (row0, rows),
    then ``grad_tensors``' 10 tensors. Each gets its gradient in its own
    dtype where ``ctx.needs_input_grad`` asks for it. The direction-form
    table gets none: it feeds only the occlusion tests, which the JAX VJP
    never differentiates."""

    @staticmethod
    def forward(ctx, scene, host, row0, rows, *tensors):
        scene, camera = _on_device(*_with_tensors(scene, tensors))
        tables, kwargs = _pack(scene, camera, row0, rows, **host)
        image, *aux = render_fwd(*tables, **kwargs, save_aux=True)
        coefs, _, colors, refl, lights, _, _, cam = tables
        ctx.save_for_backward(coefs, colors, refl, lights, cam, *aux,
                              *grad_tensors(scene, camera))
        ctx.scene, ctx.kwargs, ctx.gather = scene, kwargs, host["slots"][0]
        ctx.devices = [t.device for t in tensors]
        return image

    @staticmethod
    def backward(ctx, grad_image):
        coefs, colors, refl, lights, cam, aux_t, aux_slot, aux_occ, *leaves = ctx.saved_tensors
        kw = ctx.kwargs
        vec = render_bwd(coefs, colors, refl, lights, cam,
                         grad_image.to(torch.float32).contiguous(), aux_t, aux_slot, aux_occ,
                         width=kw["width"], height=kw["height"], rows=kw["rows"],
                         n_lights=lights.shape[0], bounces=kw["bounces"])
        scene, camera = _with_tensors(ctx.scene, leaves)
        grads = pack_vjp(vec, ctx.gather, scene, camera, wanted=ctx.needs_input_grad[4:])
        return (None, None, None, None,
                *(g if g is None or g.device == d else g.to(d)
                  for g, d in zip(grads, ctx.devices)))


class PipelineGradRender(torch.autograd.Function):
    """A full frame for a scene the fused backward cannot encode (more than
    31 lights, or no object): the forward is one ``render_fwd`` launch
    without aux, the backward recomputes the VJP through the plain pipeline
    at ``RenderConfig("float32", polish_iters, bounces, chunk_px=None)``
    under ``torch.enable_grad()`` (the counterpart of ``_diff_bwd``,
    :2134-2152).

    As in the JAX package, the pipeline's occlusion solves use the full
    ``polish_iters`` while the kernel forward uses the (coarser)
    ``shadow_iters``, so primal and gradient can disagree on occlusion
    classification at penumbra-boundary pixels — acceptable because
    occlusion is a non-differentiable boolean (detached in the pipeline)
    and the disagreement set is the measure-zero root-selection boundary.

    Inputs: the scene (its differentiable tensors are replaced by the next
    ones), the frame's host half (``_host_half``: the iteration counts and
    the slot statics, derived outside any capture), then ``grad_tensors``'
    10 tensors. A requested gradient that the frame does not depend on (a
    light's, with no object) is zero. On the card the forward and the
    backward each replay a CUDA graph (``_pipeline_grad_frame``).
    """

    @staticmethod
    def forward(ctx, scene, host, *tensors):
        scene, camera = _with_tensors(scene, tensors)
        tables, fwd_kwargs = _pack(scene, camera, 0, scene.height, **host)
        ctx.scene, ctx.kwargs = scene, fwd_kwargs
        ctx.save_for_backward(*tensors)
        return render_fwd(*tables, **fwd_kwargs)

    @staticmethod
    def backward(ctx, grad_image):
        wanted = ctx.needs_input_grad[2:]
        leaves = [t.detach().requires_grad_(w) for t, w in zip(ctx.saved_tensors, wanted)]
        config = pipeline.RenderConfig("float32", ctx.kwargs["polish_iters"],
                                       ctx.kwargs["bounces"], chunk_px=None)
        with torch.enable_grad():
            scene, camera = _with_tensors(ctx.scene, leaves)
            image = pipeline._render_image(scene, camera, config)
            inputs = [t for t in leaves if t.requires_grad]
            grads = (torch.autograd.grad(image, inputs, grad_image, allow_unused=True)
                     if image.requires_grad else [None] * len(inputs))
        grads = iter(grads)
        out = []
        for t, w in zip(leaves, wanted):
            g = next(grads) if w else None
            out.append(torch.zeros_like(t) if w and g is None else g)
        return (None, None, *out)


def _host_half(scene: Scene, polish_iters: int, bounces, shadow_iters) -> dict:
    """``_pack``'s keyword arguments that ``pack_frame`` derives on the host:
    the iteration counts and the slot statics, memoised per table."""
    bounces, shadow_iters = _iteration_counts(scene, polish_iters, bounces, shadow_iters)
    return dict(n_cubic=_statics_for(scene.coefs)[1], slots=_slot_tables(scene.coefs),
                polish_iters=int(polish_iters), bounces=bounces, shadow_iters=shadow_iters)


def _frame_tensors(scene: Scene, camera: camera_ops.Camera) -> list:
    """Every tensor a frame reads, in the order its graphs take them:
    ``grad_tensors``' and the light kinds."""
    return [*grad_tensors(scene, camera), scene.light_is_spherical]


# The frames' graphs (forward, and forward + backward), by key.
_FRAMES = graphs.GraphCache()


def _frame_key(scene: Scene, camera: camera_ops.Camera, row0: int, rows: int,
               polish_iters: int, bounces: int, shadow_iters: int, wants_grad: bool) -> tuple:
    """The key of a frame's graph: what the capture fixed on the host (the
    statics, the iteration counts, the rows and the image's size) and the
    tables' shapes, dtypes, devices and, for a differentiable frame, which
    of them require grad. The camera's and the tables' values are not in it."""
    return (wants_grad, _statics_for(scene.coefs), (scene.width, scene.height),
            int(row0), int(rows), int(polish_iters), bounces, shadow_iters,
            graphs.signature(_frame_tensors(scene, camera), wants_grad))


def _render_rows_graphed(scene: Scene, camera: camera_ops.Camera, row0: int, rows: int,
                         polish_iters: int, bounces, shadow_iters, wants_grad: bool):
    """``_render_rows_eager`` as a replayed CUDA graph of the frame's key
    (``_frame_key``, ``graphs.GraphCache``)."""
    with span("trt.frame.key"):
        host = _host_half(scene, polish_iters, bounces, shadow_iters)
        key = _frame_key(scene, camera, row0, rows, polish_iters, host["bounces"],
                         host["shadow_iters"], wants_grad)

    def body(*tensors):
        s, c = _with_tensors(dataclasses.replace(scene, light_is_spherical=tensors[-1]),
                             tensors[:-1])
        if wants_grad:
            return FrameRender.apply(s, host, row0, rows, *grad_tensors(s, c))
        tables, kwargs = _pack(s, c, row0, rows, **host)
        return render_fwd(*tables, **kwargs)

    return _replay_frame(key, scene.coefs.device, body, _frame_tensors(scene, camera))


def _replay_frame(key, device, body, inputs):
    """``body(*inputs)`` through the ``graphs.Graph`` of ``key`` in ``_FRAMES``."""
    return _FRAMES.run(key, device, lambda: graphs.Graph(device, body, inputs),
                       lambda: body(*inputs), inputs)


def _render_rows_eager(scene: Scene, camera: camera_ops.Camera, row0: int, rows: int,
                       *, polish_iters: int = 3, bounces: int | None = None,
                       shadow_iters: int | None = None) -> torch.Tensor:
    """``render_rows_kernel``'s eager body: the packing, then one
    ``render_fwd`` launch, through ``FrameRender`` when differentiable."""
    host = _host_half(scene, polish_iters, bounces, shadow_iters)
    if _wants_grad(scene, camera):
        return FrameRender.apply(scene, host, row0, rows, *grad_tensors(scene, camera))
    tables, kwargs = _pack(scene, camera, row0, rows, **host)
    return render_fwd(*tables, **kwargs)


def render_rows_kernel(scene: Scene, camera: camera_ops.Camera, row0: int, rows: int,
                       *, polish_iters: int = 3, bounces: int | None = None,
                       shadow_iters: int | None = None) -> torch.Tensor:
    """Render image rows [row0, row0 + rows) -> [rows, W, 3] f32 on the
    scene's device, ``row0`` entering the kernel through cam[17] (the
    per-device body of a row-sharded render, ``render_rows_pallas``).

    Unlike the JAX entry, the scene statics are always derived from the
    tables: a torch tensor is never abstract. ``bounces=None`` runs the
    reflection chain to ``max_reflections`` when any object reflects.

    On CUDA tables the call replays a CUDA graph of its key, as the JAX
    entry launches the executable that ``jax.jit`` compiled for its static
    arguments (``render/graphs.py``): the first call of a key runs eagerly,
    the second captures the graph, and the result is a fresh tensor. On
    CPU tables, inside ``graphs.eager()`` and inside a capture it runs
    eagerly (``_render_rows_eager``).

    Differentiable when a scene or camera tensor requires grad (see
    ``FrameRender``); on the card the forward and the backward each replay
    a graph and the gradients are fresh tensors. The gradients of row blocks
    sum to the frame's. The fused backward covers scenes with at least one
    object and at most 31 lights; for any other scene this row-block form
    is forward-only, as ``render_rows_pallas`` is (:2183-2190): a gradient
    raises ``NotImplementedError``, and ``render_image_kernel`` gives it.
    """
    wants_grad = _wants_grad(scene, camera)
    if wants_grad and not _fused_backward_encodes(scene):
        raise NotImplementedError(
            f"render_rows_kernel: no gradient for a scene with {scene.n_objects} objects "
            f"and {scene.n_lights} lights: the fused backward needs at least one object "
            f"and at most {MAX_AUX_LIGHTS} lights; render the full frame with "
            "render_image_kernel, whose gradient recomputes such scenes through the "
            "plain pipeline")
    if graphs.active(scene.coefs.device):
        return _render_rows_graphed(scene, camera, row0, rows, polish_iters, bounces,
                                    shadow_iters, wants_grad)
    return _render_rows_eager(scene, camera, row0, rows, polish_iters=polish_iters,
                              bounces=bounces, shadow_iters=shadow_iters)


def _pipeline_grad_frame(scene: Scene, camera: camera_ops.Camera, polish_iters: int, bounces,
                         shadow_iters) -> torch.Tensor:
    """The differentiable frame of a scene the fused backward cannot encode
    (``PipelineGradRender``). On the card, outside ``graphs.eager()``, its
    forward (the packing and one K1 launch) and its backward (the pipeline's
    recompute and its autograd) replay the two graphs of the frame's key
    (``graphs.Graph``); the image and the gradients are fresh tensors."""
    host = _host_half(scene, polish_iters, bounces, shadow_iters)
    device = scene.coefs.device
    if not graphs.active(device):
        return PipelineGradRender.apply(scene, host, *grad_tensors(scene, camera))
    key = ("pipeline_grad", _frame_key(scene, camera, 0, scene.height, polish_iters,
                                       host["bounces"], host["shadow_iters"], True))

    def body(*tensors):
        return PipelineGradRender.apply(
            dataclasses.replace(scene, light_is_spherical=tensors[-1]), host, *tensors[:-1])

    return _replay_frame(key, device, body, _frame_tensors(scene, camera))


def render_image_kernel(scene: Scene, camera: camera_ops.Camera | None = None,
                        polish_iters: int = 3, bounces: int | None = None,
                        shadow_iters: int | None = None) -> torch.Tensor:
    """Render a full frame -> [H, W, 3] f32 on the scene's device, row 0 at
    the bottom: the counterpart of ``render_image_pallas``.

    Differentiable: with the fused backward (``FrameRender``,
    ``render_rows_kernel``) where it encodes the scene, else through
    ``PipelineGradRender``, whose backward recomputes the frame through the
    plain pipeline. On the card both replay CUDA graphs, a forward graph and
    a backward graph for each key.

    ``camera`` defaults to the reference pose. ``shadow_iters`` sets the
    Newton steps of the shadow-occlusion solves, clamped to
    [1, polish_iters]; the default 1 is the Pallas kernel's.
    """
    with span("trt.frame"):
        if camera is None:
            camera = camera_ops.Camera.initial(torch.float32, scene.coefs.device)
        if _wants_grad(scene, camera) and not _fused_backward_encodes(scene):
            return _pipeline_grad_frame(scene, camera, polish_iters, bounces, shadow_iters)
        return render_rows_kernel(scene, camera, 0, scene.height,
                                  polish_iters=polish_iters, bounces=bounces,
                                  shadow_iters=shadow_iters)
