"""The ``fit`` driver: inverse rendering, as the port's ``cli.py fit`` runs it.

Set-up makes the inputs and one train step. The target is the configuration's
scene, unperturbed, rendered by the plain reference (``reference/``) at the
reference pose, in float32 at the mix's polish: an input that both sides
read. The program's problem is ``InverseProblem`` over the configuration's
``fit_fields``, each perturbed by a factor drawn from the seed in the mix's
``perturb`` range (``coefs`` in its constant column, as the CLI does), at
the mix's polish, learning rate, backend and soft temperature; the step is
``make_train_step(problem)``, driven with its parameters, its optimizer, the
reference pose and the target. Set-up runs the first ``setup_steps`` steps
through that same call (the first, while Adam has no state, runs eagerly;
the second captures the step's CUDA graph and replays it), then hands the
same step to the window, where each step returns its loss to the host. A
soft problem's temperature follows ``tau_schedule(soft_tau, tau_final,
tau_steps)`` and stays at ``tau_final`` after it.

Correctness: the reference follows the first ``setup_steps`` steps (in the
configuration's reference dtype), and three numbers are compared:
``loss_gap``, the largest relative gap of a step's loss; ``grad_gap``, the
worst leaf's gap between the norms of the first gradient (Adam's first
moment after one step over 1 - beta1) relative to the larger of the
reference's norm of that leaf and of the median leaf; ``change_gap``, the
same of the parameters' change over those steps, leaving out the leaves
whose reference gradient is under a thousandth of the median leaf's.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import time

import torch

from .. import flysession, roofline
from ..reference import fit as ref

def _norms(tensors: dict) -> dict:
    return {k: float(v.detach().double().norm()) for k, v in tensors.items()}


def gaps(program: dict, reference: dict) -> dict:
    """The three numbers compared, from {"losses", "grad1", "change"} of the
    program and of the reference (see the module's docstring)."""
    loss_gap = max(abs(a - b) / abs(b) if b else math.inf
                   for a, b in zip(program["losses"], reference["losses"]))
    g_prog, g_ref = _norms(program["grad1"]), _norms(reference["grad1"])
    g_med = statistics.median(g_ref.values())
    grad_gap = max(abs(g_prog[k] - g_ref[k]) / max(g_ref[k], g_med) for k in g_ref)
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    c_prog, c_ref = _norms(program["change"]), _norms(reference["change"])
    c_med = statistics.median(c_ref[k] for k in moved)
    change_gap = max(abs(c_prog[k] - c_ref[k]) / max(c_ref[k], c_med) for k in moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}


def factors(cell, seed: int) -> dict:
    """Each optimized field's perturbation factor, drawn from the seed."""
    r = flysession.rng(seed)
    lo, hi = cell.mix["perturb"]
    return {f: float(r.uniform(lo, hi)) for f in cell.setting["fit_fields"]}


def taus(mix: dict, steps: int):
    """The temperature of each of the first ``steps`` steps, or None."""
    if mix["soft_tau"] is None:
        return None
    t0, t1, n = mix["soft_tau"], mix["tau_final"], int(mix["tau_steps"])
    ratio = (t1 / t0) ** (1.0 / (n - 1))
    return [t0 * ratio ** min(k, n - 1) for k in range(steps)]


class Driver:
    unit = "step"

    def __init__(self, cell, seed: int, device):
        from tpu_ray_tracer_torch.diff.inverse import (InverseProblem, extract_params,
                                                       make_train_step)
        from tpu_ray_tracer_torch.models.loader import load_from_file
        from tpu_ray_tracer_torch.ops.camera import Camera
        from tpu_ray_tracer_torch.render.pipeline import RenderConfig

        t0 = time.perf_counter()
        self.cell, self.device, self.mix = cell, device, cell.mix
        self.fields = list(cell.setting["fit_fields"])
        self.factors = factors(cell, seed)
        self.polish = int(self.mix["polish_iters"])
        # the target, by the reference; its peak memory is not the program's
        scene32 = self.reference_scene(torch.float32, perturbed=False)
        self.target = ref.render_frame(scene32, ref.camera(torch.float32, device),
                                       polish_iters=self.polish).float().contiguous()
        del scene32
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)

        t1 = time.perf_counter()
        scene = load_from_file(cell.scene_path, device=device)
        if cell.size is not None:
            scene = dataclasses.replace(scene, width=cell.size[0], height=cell.size[1])
        template = ref.perturb(scene, self.factors)
        problem = InverseProblem(
            scene_template=template,
            config=RenderConfig("float32", polish_iters=self.polish, chunk_px=None),
            param_fields=tuple(self.fields), learning_rate=float(self.mix["learning_rate"]),
            backend=self.mix["backend"], soft_tau=self.mix["soft_tau"])
        self.params = extract_params(template.astype(torch.float32), self.fields)
        self.optimizer = problem.optimizer(self.params)
        self.step = make_train_step(problem)
        self.camera = Camera.initial(torch.float32, device)
        self.k = 0
        self.losses = []
        self.failures = 0
        start = {f: p.detach().clone() for f, p in self.params.items()}
        t2 = time.perf_counter()
        setup = int(self.mix["setup_steps"])
        for _ in range(setup):
            self.losses.append(self.call())
            if self.k == 1:
                self.grad1 = {f: (self.optimizer.state[p]["exp_avg"] / (1 - ref.ADAM_BETA1)).clone()
                              for f, p in self.params.items()}
        # the parameters after the set-up steps, as far as the next step keeps them
        self.first = {"losses": list(self.losses), "grad1": self.grad1,
                      "change": {f: p.detach() - start[f] for f, p in self.params.items()}}
        self.at_trace = None
        self.reference_s = t1 - t0  # the reference's, not the program's set-up
        self.phases = {"target": t1 - t0, "problem": t2 - t1, "setup_steps": time.perf_counter() - t2}

    def tau(self, k: int):
        t = taus(self.mix, k + 1)
        return None if t is None else t[k]

    def call(self) -> float:
        loss = self.step(self.params, self.optimizer, self.camera, self.target, self.tau(self.k))
        self.k += 1
        return loss

    def before_trace(self) -> None:
        self.at_trace = {f: p.detach().clone() for f, p in self.params.items()}

    def run_unit(self, span) -> None:
        with span("port_bench.step"):
            loss = self.call()
        self.failures += not math.isfinite(loss)

    def end_to_end(self, window_s: float, n: int) -> dict:
        return {self.mix["step_metric"]: window_s * 1e3 / n}

    def free(self) -> None:
        self.step = self.optimizer = self.params = None

    def reference_scene(self, dtype, perturbed: bool = True):
        scene = ref.load_scene(self.cell.scene_path, self.device, dtype)
        if self.cell.size is not None:
            scene = dataclasses.replace(scene, width=self.cell.size[0], height=self.cell.size[1])
        return ref.perturb(scene, self.factors) if perturbed else scene

    def follow(self, reference=None, rows=None) -> dict:
        """The reference's first steps ({"losses", "grad1", "change"}) in the
        dtype of ``reference`` (the configuration's by default); ``rows``
        short of the height leaves the rest of the rows out."""
        reference = reference or self.cell.setting["reference"]
        template = self.reference_scene(getattr(torch, reference["dtype"]))
        steps = int(self.mix["setup_steps"])
        t = taus(self.mix, steps)
        return ref.fit_steps(template, self.fields, self.target, steps=steps,
                             lr=float(self.mix["learning_rate"]), polish_iters=self.polish,
                             taus=t, rows=rows)

    def check(self) -> dict:
        got = gaps(self.first, self.follow())
        return {k: {"value": v, "limit": self.cell.limits[k]} for k, v in got.items()}

    def least(self, trace, kernel: str) -> dict:
        """{unit: least seconds} of K1 (with its aux) or K2 for every step of
        the traced slice, counted at the parameters at the slice's start."""
        if kernel not in ("k1", "k2") or self.at_trace is None:
            return {}
        scene = dataclasses.replace(self.reference_scene(torch.float32, perturbed=False),
                                    **{f: v.float() for f, v in self.at_trace.items()})
        work = roofline.frame_work(scene, ref.camera(torch.float32, self.device),
                                   polish_iters=self.polish, save_aux=True)
        return {u: work[kernel] for u in range(trace.units)}
