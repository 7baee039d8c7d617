"""The soft fit's plain reference (``reference/soft.py``), written apart from
the port's pipeline, agrees with the port's soft render where both are exact,
and finds the roots it is defined to find."""

import dataclasses
import math
from pathlib import Path

import pytest
import torch

from port_bench.reference import fit as ref
from port_bench.reference import soft

ROOT = Path(__file__).resolve().parents[2]
FIELDS = ("coefs", "light_color")


def poly(*roots, scale=1.0):
    """Coefficients a0..a3 of scale * prod(t - r)."""
    p = [scale]
    for r in roots:
        p = [0.0] + p
        p = [p[i] - r * (p[i + 1] if i + 1 < len(p) else 0.0) for i in range(len(p))]
    return p + [0.0] * (4 - len(p))


@pytest.mark.parametrize("roots,scale", [((-2.0, 0.5, 3.0), 1.0), ((0.1, 0.2, 40.0), -3.0),
                                         ((1.5,), 2.0), ((-1.0, 4.0), 0.5), ((7.0,), -1.0)])
def test_real_roots_of_known_polynomials(roots, scale):
    got = soft.real_roots(torch.tensor([poly(*roots, scale=scale)], dtype=torch.float64))[0]
    want = sorted(roots) + [math.inf] * (3 - len(roots))
    assert got.tolist() == pytest.approx(want, rel=1e-12, abs=1e-12)


def test_a_cubic_with_one_real_root():
    # (t - 2)(t^2 + 1)
    got = soft.real_roots(torch.tensor([[-2.0, 1.0, -2.0, 1.0]], dtype=torch.float64))[0]
    assert got[0].item() == pytest.approx(2.0) and math.isinf(got[1]) and math.isinf(got[2])


@pytest.mark.parametrize("roots,survivor", [((0.5, 1.0, 5.0), 5.0), ((0.5, 4.5, 5.0), 0.5)])
def test_the_merging_pair_is_the_one_whose_critical_value_is_nearer_zero(roots, survivor):
    a = torch.tensor([poly(*roots)], dtype=torch.float64)[:, None, :]
    t_a, t_b = soft.branch_roots(a, torch.tensor([True]))
    assert t_a.item() == pytest.approx(0.5) and t_b.item() == pytest.approx(survivor)
    assert -1.0 < soft.pair_delta(a, torch.tensor([True])).item() < 0.0


def _scene(w, h):
    scene = ref.load_scene(ROOT / "port_bench" / "configs" / "clebsch-800x600.yml", "cpu",
                           torch.float64)
    return ref.perturb(dataclasses.replace(scene, width=w, height=h),
                       {"coefs": 0.6, "light_color": 0.6})


def test_pair_delta_equals_the_ports_pair_coverage():
    from tpu_ray_tracer_torch.diff.soft import pair_coverage

    scene = _scene(24, 18)
    origin, dirs = soft.rays(scene, [0.0, 0.0, 0.0], 90.0, 0.0, 0, 18)
    kinds = torch.tensor([True])
    want = pair_coverage(scene.coefs, origin, dirs, pair_kinds=kinds)
    got = soft.pair_delta(soft.along(scene.coefs, origin, dirs), kinds)
    assert torch.allclose(got, want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("tau", [0.15, 0.05])
def test_the_soft_render_and_its_gradient_equal_the_ports_in_float64(tau):
    from tpu_ray_tracer_torch.diff.soft import render_rays_soft
    from tpu_ray_tracer_torch.models.loader import load_from_file
    from tpu_ray_tracer_torch.ops import camera as camera_ops

    w, h = 32, 24
    scene = _scene(w, h)
    kinds = torch.tensor([True])
    theirs = load_from_file(ROOT / "port_bench" / "configs" / "clebsch-800x600.yml",
                            device="cpu").astype(torch.float64, torch.float64)
    theirs = dataclasses.replace(theirs, width=w, height=h,
                                 **{f: getattr(scene, f) for f in ("coefs", "light_color")})
    cam = camera_ops.Camera.initial(torch.float64, "cpu")
    rotation, eye = camera_ops.camera_frame(cam)
    dirs = camera_ops.pixel_directions(rotation, w, h, theirs.aspect_ratio,
                                       theirs.tan_half_fov).reshape(-1, 3)
    out = []
    for render in ("ours", "theirs"):
        params = {f: getattr(scene, f).clone().requires_grad_() for f in FIELDS}
        if render == "ours":
            origin, d = soft.rays(dataclasses.replace(scene, **params), [0.0, 0.0, 0.0], 90.0,
                                  0.0, 0, h)
            img = soft.render_soft(dataclasses.replace(scene, **params), origin, d, tau, kinds)
        else:
            img = render_rays_soft(dataclasses.replace(theirs, **params), eye.expand(dirs.shape),
                                   dirs, polish_iters=2, tau=tau, pair_kinds=kinds)
        grads = torch.autograd.grad(img.square().sum(), list(params.values()))
        out.append((img.detach(), grads))
    (ours, g_ours), (want, g_want) = out
    assert (ours - want).abs().max() < 1e-4
    for g, gw in zip(g_ours, g_want):
        assert (g - gw).norm() < 1e-3 * gw.norm()
