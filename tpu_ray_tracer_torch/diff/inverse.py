"""Inverse rendering: recover scene parameters from a target image.

Counterpart of ``tpu_ray_tracer/diff/inverse.py``. The render is
differentiable end to end, so scene parameters (and the camera pose) are
optimized by Adam to match a target image (the BASELINE.json configuration:
recover clebsch.yml's surface coefficients and light parameters from a
rendered target).

The loss is the sum of squared errors over the frame's rows divided by
``H * W * 3``. It routes as the JAX package's does: through the two
hand-written kernels (``render_rows_kernel``: the forward with its saved
per-stage data, then the fused backward) when there is no soft-visibility
temperature, at least one object and at most 31 lights; through the plain
PyTorch pipeline (``render_rays``, or ``render_rays_soft`` for a soft loss)
otherwise. The pipeline keeps its whole autograd graph, so its loss is
computed and differentiated one row block at a time, the block sized from
the scene's [rays, lights, objects] work; the loss is a sum over pixels, so
the gradients of the blocks add up to the frame's exactly.

The loss is written over a block of rows [y0, y0 + rows), so a row-sharded
fit (the JAX ``make_loss_fn(problem, mesh)``) adds only a process group:
rank r takes rows [r * rows_local, (r + 1) * rows_local) of the frame
(``parallel/sharding.py``), and one all-reduce sums the loss and the
gradients before the clip and the optimizer step, so that every rank takes
the same step.

Checkpoints are ``.npz`` files with tree-path keys: ``params/<field>`` (the
camera as ``params/camera/<position|yaw_deg|pitch_deg>``), ``__step__``, and
the Adam state as ``opt/<param key>/<exp_avg|exp_avg_sq|step>``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from ..models.scene import Scene
from ..ops import camera as camera_ops
from ..parallel.sharding import padded_rows, rank_and_size
from ..render.fwd_kernel import MAX_AUX_LIGHTS
from ..render.kernel_backend import render_rows_kernel
from ..render.pipeline import RenderConfig, render_rays, resolve_bounces

# --- parameterization ---

DEFAULT_PARAM_FIELDS = ("coefs", "light_color")
_CAMERA_FIELDS = ("position", "yaw_deg", "pitch_deg")


def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().clone().requires_grad_()


def extract_params(scene: Scene, fields=DEFAULT_PARAM_FIELDS, camera=None) -> dict:
    """The optimizable tensors of a scene as fresh leaves that require grad.

    The pseudo-field ``"camera"`` optimizes the camera pose itself (a
    ``Camera`` of leaves: position, yaw, pitch); pass the initial pose as
    ``camera``."""
    params = {}
    for name in fields:
        if name == "camera":
            if camera is None:
                raise ValueError("param field 'camera' needs an initial pose: pass "
                                 "camera= to extract_params/fit")
            params["camera"] = camera_ops.Camera(*(_leaf(getattr(camera, f))
                                                   for f in _CAMERA_FIELDS))
        else:
            params[name] = _leaf(getattr(scene, name))
    return params


def apply_params(scene: Scene, params: dict) -> Scene:
    """Graft the parameters onto a scene template (the ``camera``
    pseudo-field is not a scene table: the render takes it directly)."""
    return dataclasses.replace(scene, **{k: v for k, v in params.items() if k != "camera"})


def _named_tensors(params: dict):
    """(tree-path key, tensor) of every parameter leaf, in a fixed order."""
    for name, value in params.items():
        if name == "camera":
            for f in _CAMERA_FIELDS:
                yield f"camera/{f}", getattr(value, f)
        else:
            yield name, value


def param_tensors(params: dict) -> list:
    """The parameters' leaf tensors, the argument of an optimizer."""
    return [t for _, t in _named_tensors(params)]


def params_from_arrays(arrays: dict, device) -> dict:
    """Parameters as leaf tensors on ``device`` from numpy arrays: a JAX
    ``extract_params`` dict taken through ``np.asarray``, with ``camera``
    given as a dict (or any object) with position, yaw_deg and pitch_deg."""
    params = {}
    for name, value in arrays.items():
        if name == "camera":
            get = value.get if isinstance(value, dict) else lambda f: getattr(value, f)
            params["camera"] = camera_ops.Camera(*(
                torch.as_tensor(np.asarray(get(f)), device=device).clone().requires_grad_()
                for f in _CAMERA_FIELDS))
        else:
            params[name] = torch.as_tensor(np.asarray(value), device=device).clone()
            params[name].requires_grad_()
    return params


def params_to_arrays(params: dict) -> dict:
    """The inverse of ``params_from_arrays``: numpy arrays, ``camera`` as a
    dict of position, yaw_deg and pitch_deg."""
    out = {}
    for name, value in params.items():
        if name == "camera":
            out["camera"] = {f: getattr(value, f).detach().cpu().numpy() for f in _CAMERA_FIELDS}
        else:
            out[name] = value.detach().cpu().numpy()
    return out


# --- the problem, the loss and the train step ---

@dataclasses.dataclass(frozen=True)
class InverseProblem:
    """Static description of one inverse-rendering run."""

    scene_template: Scene          # concrete scene (non-optimized tables used as-is)
    config: RenderConfig = RenderConfig(polish_iters=3)
    param_fields: tuple = DEFAULT_PARAM_FIELDS
    learning_rate: float = 1e-2
    grad_clip: float | None = None  # optional global-norm clip before each step
    backend: str = "torch"         # "kernel": the forward and backward kernels
    #                                 (> 31 lights, no object or a soft loss
    #                                 take the pipeline)
    soft_tau: float | None = None  # soft-visibility temperature (diff/soft.py);
    #                                 None = hard render; bounce-free scenes only

    def optimizer(self, params: dict) -> torch.optim.Adam:
        """Adam over the parameters; its defaults equal ``optax.adam``'s
        (betas 0.9, 0.999; eps 1e-8 outside the square root)."""
        return torch.optim.Adam(param_tensors(params), lr=self.learning_rate)


# Elements of [rays, lights + 1, objects] solves (each stage's primary and
# shadow solves; twice for the soft render's two branches) in one row block
# of the pipeline route. The pipeline holds ~190 bytes an element in a
# forward and its graph at most twice that, so a block stays near 1.5 GiB.
_BLOCK_ELEMENTS = 1 << 22


class Loss:
    """The fit's loss for one problem: SSE over the target's rows divided by
    ``H * W * 3`` (``make_loss_fn``).

    ``block_sse`` renders rows [y0, y0 + rows) and returns their sum of
    squared errors, differentiable; ``__call__`` is the whole frame's loss
    as one differentiable tensor, in one process; ``backward`` computes the
    loss and accumulates its gradient into the parameters' ``.grad`` one row
    block at a time (the whole span in one block on the kernel route), and
    returns the loss, detached.

    With a process group (``group``, as a ``parallel.sharding.Mesh`` holds
    it; None is one process) ``backward`` covers this rank's rows ``span``
    and then all-reduces the loss and every parameter's ``.grad``, which
    must be None or zero on entry, so that every rank returns the frame's
    loss and holds the frame's gradient."""

    def __init__(self, problem: InverseProblem, group=None):
        template = problem.scene_template
        self.problem = problem
        # Resolved once from the template: an optimized reflection table
        # must not change the trip count mid-fit.
        self.bounces = resolve_bounces(template, problem.config)
        if problem.soft_tau is not None and self.bounces != 0:
            raise ValueError("soft_tau requires a bounce-free configuration")
        self.template = template.astype(problem.config.dtype)
        # Static per-object pair kinds for the soft blend, from the template,
        # so that quadric-class objects keep the quadratic discriminant when
        # descent drifts their cubic entries off zero (diff/soft.py).
        self.pair_kinds = (tuple((template.coefs[:, :10].abs() > 0).any(1).tolist())
                           if problem.soft_tau is not None else None)
        # the fused backward encodes at least one object and at most 31
        # lights; a soft loss is a pipeline feature
        self.use_kernel = (problem.backend == "kernel" and problem.soft_tau is None
                           and 0 < template.n_objects and template.n_lights <= MAX_AUX_LIGHTS)
        self.n_valid = template.height * template.width * 3
        if self.use_kernel:
            self.block_rows = template.height
        else:
            per_ray = (max(template.n_objects, 1) * (template.n_lights + 1) * (self.bounces + 1)
                       * (1 if problem.soft_tau is None else 2))
            self.block_rows = max(1, min(template.height,
                                         _BLOCK_ELEMENTS // (per_ray * template.width)))
        self.group = group
        rank, n = rank_and_size(self.group)
        rows_local = padded_rows(template.height, n) // n
        y0 = min(rank * rows_local, template.height)
        # this rank's rows, clipped to the height: with few rows against many
        # ranks (3 rows over 4) the last ranks' spans are short or empty
        self.span = (y0, min(rows_local, template.height - y0))

    def render_rows(self, params: dict, camera, y0: int, rows: int, tau=None):
        """Image rows [y0, y0 + rows) -> [rows, W, 3] f32 at the parameters."""
        scene = apply_params(self.template, params)
        camera = params.get("camera", camera)
        polish = self.problem.config.polish_iters
        if self.use_kernel:
            return render_rows_kernel(scene, camera, y0, rows, polish_iters=polish,
                                      bounces=self.bounces)
        rotation, eye = camera_ops.camera_frame(camera)
        dirs = camera_ops.pixel_directions(rotation, scene.width, scene.height,
                                           scene.aspect_ratio, scene.tan_half_fov,
                                           y0=y0, rows=rows)
        origin = eye.expand(dirs.shape)
        if self.problem.soft_tau is not None:
            from .soft import render_rays_soft

            return render_rays_soft(scene, origin, dirs, polish_iters=polish,
                                    tau=self.problem.soft_tau if tau is None else float(tau),
                                    pair_kinds=self.pair_kinds)
        return render_rays(scene, origin, dirs, polish_iters=polish, bounces=self.bounces)

    def block_sse(self, params: dict, camera, target, y0: int, rows: int, tau=None):
        """Sum of squared errors of rows [y0, y0 + rows) against the same
        rows of ``target`` (rows past the scene's height are left out)."""
        rows = min(rows, self.template.height - y0)
        err = self.render_rows(params, camera, y0, rows, tau) - target[y0:y0 + rows]
        return (err * err).sum()

    def __call__(self, params: dict, camera, target, tau=None):
        if self.group is not None:
            raise ValueError("a row-sharded Loss has no whole-frame tensor in one rank; "
                             "call backward(), which all-reduces the loss and the gradients")
        return self.block_sse(params, camera, target, 0, self.template.height, tau) / self.n_valid

    def backward(self, params: dict, camera, target, tau=None):
        start, rows = self.span
        total = None
        for y0 in range(start, start + rows, self.block_rows):
            block = min(self.block_rows, start + rows - y0)
            loss = self.block_sse(params, camera, target, y0, block, tau) / self.n_valid
            loss.backward()
            total = loss.detach() if total is None else total + loss.detach()
        if self.group is None:
            return total
        # The collective comes after the block loop, never inside it: ranks
        # run different numbers of row blocks (on the pipeline route a short
        # span runs fewer, and an empty span none), and every rank must call
        # the same collectives in the same order or the job deadlocks. A rank
        # that rendered nothing, or whose rows no parameter reached, has
        # .grad None: it contributes zeros.
        tensors = param_tensors(params)
        for t in tensors:
            if t.grad is None:
                t.grad = torch.zeros_like(t)
        if total is None:
            total = torch.zeros((), dtype=torch.float32, device=target.device)
        flat = torch.cat([total.reshape(1)] + [t.grad.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        offset = 1
        for t in tensors:
            t.grad.copy_(flat[offset:offset + t.numel()].view_as(t.grad))
            offset += t.numel()
        return flat[0].to(total.dtype)


def make_loss_fn(problem: InverseProblem, group=None) -> Loss:
    """The loss of ``problem``: ``loss(params, camera, target, tau=None)``
    -> 0-d tensor, and ``loss.backward(...)`` for the row-block gradient.
    ``target`` is [H, W, 3] f32 (rows past the height, from ``pad_target``,
    are ignored); ``tau`` overrides the soft temperature. With a process
    group the rows are split across its ranks (``Loss``)."""
    return Loss(problem, group)


def make_train_step(problem: InverseProblem, group=None):
    """``train_step(params, optimizer, camera, target, tau=None) -> float``:
    zero the gradients, compute the loss and its gradient (by row blocks;
    with a process group, this rank's rows, then the all-reduce), clip to
    ``grad_clip`` if set, take the optimizer step, return the loss."""
    loss_fn = make_loss_fn(problem, group)

    def train_step(params, optimizer, camera, target, tau=None) -> float:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn.backward(params, camera, target, tau)
        if problem.grad_clip is not None:
            torch.nn.utils.clip_grad_norm_(param_tensors(params), problem.grad_clip)
        optimizer.step()
        return float(loss)

    return train_step


def pad_target(target, height: int) -> torch.Tensor:
    """Pad a [H, W, 3] target with zero rows to ``height`` rows (the JAX
    ``pad_target`` pads to a multiple of the mesh for ``shard_map``; the
    port's sharded loss clips every rank's rows to the height instead)."""
    target = torch.as_tensor(target)
    pad = height - target.shape[0]
    if pad > 0:
        target = torch.cat([target, target.new_zeros((pad,) + tuple(target.shape[1:]))])
    return target


def tau_schedule(tau0: float, tau_final: float, steps: int):
    """Geometric continuation schedule tau0 -> tau_final over ``steps``."""
    if steps <= 1:
        return [tau_final]
    ratio = (tau_final / tau0) ** (1.0 / (steps - 1))
    return [tau0 * ratio ** i for i in range(steps)]


def fit(problem: InverseProblem, target, camera=None, steps: int = 200, log_every: int = 25,
        print_fn=print, checkpoint_path=None, checkpoint_every: int = 0,
        tau_final: float | None = None, group=None):
    """Run the optimization loop; returns (params, losses).

    With a process group (``group``; None is one process) the rows are
    split across its ranks and every rank takes the same steps; only rank 0
    prints and writes checkpoints.

    ``tau_final`` (soft problems only) anneals the temperature geometrically
    from ``problem.soft_tau`` to ``tau_final`` over the steps. With
    ``checkpoint_path`` an existing checkpoint is resumed from, and every
    ``checkpoint_every`` steps rank 0 writes one.

    On the kernel route the scene statics (the cubics-first slot order and
    posdef) are memoised on the coefficient tensor's version counter, which
    every in-place optimizer step bumps: each step derives them from the
    current iterate, so a step that turns a quadric cubic re-routes it. The
    memo is per rank; all ranks hold equal parameters (the all-reduced
    gradient is the same on every rank), so each derives the same slot
    order."""
    rank, _ = rank_and_size(group)
    if rank != 0:
        print_fn = _quiet
    template = problem.scene_template
    dtype, device = problem.config.dtype, template.coefs.device
    if camera is None:
        camera = camera_ops.Camera.initial(dtype, device)
    camera = camera.to(dtype, device)
    params = extract_params(template.astype(dtype), problem.param_fields, camera=camera)
    optimizer = problem.optimizer(params)
    step0 = 0
    if checkpoint_path is not None:
        restored = load_checkpoint(checkpoint_path, params, optimizer)
        if restored is not None:
            step0 = restored
            print_fn(f"resumed from {checkpoint_path} at step {step0}")

    train_step = make_train_step(problem, group)
    # no padding to a multiple of the ranks: every rank's span is clipped to
    # the height (Loss.span), so rows past it are never read
    target = torch.as_tensor(target, dtype=torch.float32, device=device)
    taus = None
    if tau_final is not None:
        if problem.soft_tau is None:
            raise ValueError("tau_final requires a soft_tau problem")
        taus = tau_schedule(problem.soft_tau, tau_final, steps)
    losses = []
    for step in range(step0, steps):
        loss = train_step(params, optimizer, camera, target,
                          None if taus is None else taus[step])
        losses.append(loss)
        if log_every and (step % log_every == 0 or step == steps - 1):
            print_fn(f"step {step}: loss {loss:.3e}")
        if checkpoint_path and checkpoint_every and (step + 1) % checkpoint_every == 0:
            # rank 0 only: every rank holds the same parameters, and the
            # path typically lives on a shared filesystem
            if rank == 0:
                save_checkpoint(checkpoint_path, params, optimizer, step + 1)
    return params, losses


def _quiet(*args, **kwargs) -> None:
    """The print function of every rank but rank 0."""


# --- checkpoints (.npz with tree-path keys) ---

_ADAM_STATE = ("exp_avg", "exp_avg_sq", "step")


def save_checkpoint(path, params: dict, optimizer: torch.optim.Optimizer | None,
                    step: int) -> None:
    """Write the parameters, the Adam state and the step count to ``path``.

    Atomic (a temp file, then ``os.replace``): a crash mid-save, or a reader
    racing the writer, never sees a truncated file."""
    flat = {}
    for key, t in _named_tensors(params):
        flat[f"params/{key}"] = t.detach().cpu().numpy()
        state = optimizer.state.get(t, {}) if optimizer is not None else {}
        for name in _ADAM_STATE:
            if name in state:
                flat[f"opt/{key}/{name}"] = torch.as_tensor(state[name]).detach().cpu().numpy()
    flat["__step__"] = np.asarray(step)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def load_checkpoint(path, params: dict, optimizer: torch.optim.Optimizer | None = None):
    """Restore ``params`` in place (and the Adam state of ``optimizer``)
    from ``path``; returns the step count, or None if there is no file.

    Raises ``KeyError`` where a parameter, or with ``optimizer`` an
    ``opt/...`` key, is missing: a resumed fit never silently restarts Adam's
    moments from zero. The ``params/...`` keys of a JAX-written checkpoint
    load alike."""
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        step = int(data["__step__"])
        for key, t in _named_tensors(params):
            name = f"params/{key}"
            if name not in data.files:
                raise KeyError(f"checkpoint {path} has no {name!r}")
            with torch.no_grad():
                t.copy_(torch.as_tensor(data[name]))
            if optimizer is None:
                continue
            missing = [n for n in _ADAM_STATE if f"opt/{key}/{n}" not in data.files]
            if missing:
                raise KeyError(f"checkpoint {path} has no optimizer state for {key!r} "
                               f"(missing {', '.join(f'opt/{key}/{n}' for n in missing)}); "
                               "resuming would restart Adam's moments from zero")
            optimizer.state[t] = {
                "step": torch.tensor(float(data[f"opt/{key}/step"])),
                "exp_avg": torch.as_tensor(data[f"opt/{key}/exp_avg"]).to(t),
                "exp_avg_sq": torch.as_tensor(data[f"opt/{key}/exp_avg_sq"]).to(t),
            }
    return step
