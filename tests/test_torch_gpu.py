"""The CUDA kernels against their plain PyTorch versions, on the card: the
forward (with and without its per-stage aux) and the backward; the plain
pipeline, the gradient fallback and the CLI on the card; the fit's
kernel-route step, its row-block pipeline backward and the soft render; and
the row-sharded frame and step over an NCCL group of one rank, and the
native scene loader on the card.

This file imports nothing of JAX, so it runs on a machine with a GPU and
without JAX, from the repository root:

    python -m pytest --noconftest tests/test_torch_gpu.py

Every case skips without a CUDA device.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import tpu_ray_tracer_torch as ttt
from tpu_ray_tracer_torch.models import light as tlight
from tpu_ray_tracer_torch.models import surface as tsurface
from tpu_ray_tracer_torch.models.scene import Object
from tpu_ray_tracer_torch.parity import bad_pixel_fraction, gradient_group_errors
from tpu_ray_tracer_torch.render import _build
from tpu_ray_tracer_torch.render.bwd_kernel import (acc_layout, bwd_plan, render_bwd,
                                                    render_bwd_plain)
from tpu_ray_tracer_torch.render.fwd_kernel import (FWD_VARIANTS, _eval_F_and_grad, _powers3,
                                                    fwd_variant, render_fwd, render_fwd_plain)
from tpu_ray_tracer_torch.render.kernel_backend import pack_frame, render_rows_kernel

pytestmark = pytest.mark.gpu

SCENE_DIR = pathlib.Path(__file__).resolve().parent.parent / "scenes"
SCENES = ["quadratic", "20spheres", "reflection_test", "dingdong",
          "cayley", "clebsch", "cubic", "monkey_saddle"]
POSES = [((0.0, 0.0, 0.0), 90.0, 0.0), ((0.0, 2.0, -3.0), 75.0, -12.0)]
MAX_BAD_VS_PLAIN = 1e-3  # nvcc contracts multiply-adds; the plain version rounds each op


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _scene(name, device, width=64, height=48):
    scene = ttt.load_from_file(SCENE_DIR / f"{name}.yml", device=device)
    return dataclasses.replace(scene, width=width, height=height)


def _camera(pose, device):
    pos, yaw, pitch = pose
    return ttt.Camera(position=torch.tensor(pos, dtype=torch.float32, device=device),
                      yaw_deg=torch.tensor(yaw, dtype=torch.float32, device=device),
                      pitch_deg=torch.tensor(pitch, dtype=torch.float32, device=device))


def _kernel_and_plain(tables, kw):
    before = render_fwd.launches
    out = render_fwd(*tables, **kw)
    torch.cuda.synchronize()
    assert render_fwd.launches == before + 1
    assert out.device.type == "cuda" and out.shape == (kw["rows"], kw["width"], 3)
    return out.cpu().numpy(), render_fwd_plain(*tables, **kw).cpu().numpy()


@pytest.mark.parametrize("name", SCENES)
def test_kernel_matches_plain(cuda, name):
    scene = _scene(name, cuda)
    for pose in POSES:
        out, plain = _kernel_and_plain(*pack_frame(scene, _camera(pose, cuda), 0, scene.height))
        assert np.isfinite(out).all()
        assert bad_pixel_fraction(out, plain) <= MAX_BAD_VS_PLAIN, (name, pose)


def test_rows_stitch_exactly(cuda):
    scene = _scene("reflection_test", cuda, 40, 30)
    cam = _camera(POSES[1], cuda)
    full = ttt.render_image_kernel(scene, cam)
    blocks = [render_rows_kernel(scene, cam, r0, r1 - r0)
              for r0, r1 in ((0, 7), (7, 19), (19, 30))]
    assert torch.equal(torch.cat(blocks), full)


@pytest.mark.parametrize("case", ["no_objects", "no_lights"])
def test_empty_tables(cuda, case):
    """Empty object or light tables (whose data pointers may be null) render
    as the plain version does; no objects gives the background."""
    sphere = Object(tsurface.sphere((0, 0, 8), 2.0), 0.3, np.float32([0.8, 0.2, 0.1]))
    sun = tlight.directional(2.0, (0.3, -1, 0.5), (1, 1, 1))
    objects, lights = ([], [sun]) if case == "no_objects" else ([sphere], [])
    scene = ttt.build_scene(32, 24, 40.0, objects, lights, bg_color=(0.0, 0.1, 0.2),
                            device=cuda)
    out, plain = _kernel_and_plain(*pack_frame(scene, _camera(POSES[0], cuda), 0, 24))
    assert bad_pixel_fraction(out, plain) == 0.0
    if case == "no_objects":
        np.testing.assert_array_equal(out, np.broadcast_to(np.float32([0, 0.1, 0.2]),
                                                           out.shape))


def test_many_lights_and_large_tables(cuda):
    """More than 32 lights (several occlusion-mask words) and tables above
    the default 48 KB of shared memory still match the plain version."""
    rng = np.random.default_rng(7)
    objects = [Object(tsurface.sphere(rng.uniform(-4, 4, 3) + [0, 0, 14], 0.6), 0.0,
                      rng.uniform(0, 1, 3).astype(np.float32)) for _ in range(40)]
    objects.append(Object(tsurface.ding_dong((0, -1, 12)), 0.2, np.float32([1, 1, 1])))
    lights = [tlight.directional(0.05, rng.uniform(-1, 1, 3) - [0, 1, 0], (1, 1, 1))
              for _ in range(300)]
    lights.append(tlight.spherical(300.0, (0, 6, 6), (1, 1, 1)))
    scene = ttt.build_scene(48, 32, 50.0, objects, lights, max_reflections=2, device=cuda)
    tables, kw = pack_frame(scene, _camera(POSES[0], cuda), 0, 32)
    assert sum(t.numel() * t.element_size() for t in tables) > 48 * 1024
    out, plain = _kernel_and_plain(tables, kw)
    assert bad_pixel_fraction(out, plain) <= 0.01


# --- the forward's aux (K1b) and the backward (K2) ---

MAX_SLOT_MISMATCH = 1e-3  # knife-edge root choices, as MAX_BAD_VS_PLAIN


def _lambert(tables, aux_t, aux_slot, width, height, rows):
    """[S, rows, W, L] Lambert factor n.ld of each light at each stage's hit
    point, the chain rebuilt from the aux as the backward's Phase A does."""
    coefs, lights, cam = tables[0], tables[4], tables[7]
    n_obj = coefs.shape[0]
    coefs_pad = torch.cat([coefs, coefs.new_zeros(1, coefs.shape[1])])
    pix = torch.arange(rows * width, device=coefs.device)
    ndc_x = ((pix % width).float() + 0.5) / width
    ndc_y = ((pix // width).float() + cam[17] + 0.5) / height
    cx, cy = (2 * ndc_x - 1) * cam[12], (2 * ndc_y - 1) * cam[13]
    target = torch.stack([cx * cam[k] + cy * cam[3 + k] + cam[6 + k] for k in range(3)], -1)
    d = target / target.norm(dim=-1, keepdim=True)
    o = cam[9:12].expand_as(d)
    out = []
    for t, slot in zip(aux_t.reshape(len(aux_t), -1), aux_slot.reshape(len(aux_slot), -1)):
        p = o + t[:, None] * d
        sel = coefs_pad[torch.where(slot >= 0, slot, n_obj).long()].unbind(1)
        _, _, g = _eval_F_and_grad(sel, _powers3(*p.unbind(1)), need_mag=False)
        n = torch.stack(g, -1)
        n = n / n.norm(dim=-1, keepdim=True).clamp_min(1e-30)
        to = lights[None, :, 1:4] - p[:, None, :]
        ld = torch.where(lights[None, :, :1] > 0.5, to / to.norm(dim=-1, keepdim=True),
                         lights[None, :, 1:4])
        out.append((n[:, None, :] * ld).sum(-1))
        o = p + 1e-2 * n
        d = d - 2 * (d * n).sum(-1, keepdim=True) * n
    return torch.stack(out).reshape(len(aux_t), rows, width, -1)


@pytest.mark.parametrize("name", SCENES)
def test_aux_matches_plain(cuda, name):
    """K1b: the kernel's (t, slot, occlusion bits) per chain stage against
    the plain version's, and the image bitwise the same with and without
    aux. Bits are compared where the light faces the point: the kernel does
    not test a light whose Lambert factor is 0 (render_fwd docstring)."""
    scene = _scene(name, cuda)
    for pose in POSES:
        tables, kw = pack_frame(scene, _camera(pose, cuda), 0, scene.height)
        image = render_fwd(*tables, **kw)
        k_img, *k_aux = render_fwd(*tables, **kw, save_aux=True)
        _, *p_aux = render_fwd_plain(*tables, **kw, save_aux=True)
        assert torch.equal(k_img, image), (name, pose)
        (kt, ks, ko), (pt, ps, po) = k_aux, p_aux
        assert ks.shape == (kw["bounces"] + 1, scene.height, scene.width)
        same = (ks == ps).all(0)  # the pixel's whole chain agrees
        assert 1.0 - same.float().mean().item() <= MAX_SLOT_MISMATCH, (name, pose)
        hit = same & (ks >= 0)
        # f32 roots of the same polynomial, FMA-contracted on the card
        assert ((kt - pt).abs() <= 1e-4 * pt.abs())[hit].all(), (name, pose)
        # lam above 1e-5: this rebuilt factor and the kernel's may round to
        # opposite sides of 0; bits flip where the two forwards' occlusion
        # roots do, at most as often as slots
        lam = _lambert(tables, pt, ps, scene.width, scene.height, scene.height)
        bit = torch.arange(lam.shape[-1], device=cuda)
        faces = (same & (ks >= 0))[..., None] & (lam > 1e-5)
        k_bits, p_bits = ((ko[..., None] >> bit) & 1)[faces], ((po[..., None] >> bit) & 1)[faces]
        assert (k_bits != p_bits).float().mean().item() <= MAX_SLOT_MISMATCH, (name, pose)


def _bwd_case(scene, cam, **pack_kw):
    """The kernel forward's aux and a non-uniform cotangent for one frame."""
    tables, kw = pack_frame(scene, cam, 0, scene.height, **pack_kw)
    _, *aux = render_fwd(*tables, **kw, save_aux=True)
    n = scene.height * scene.width * 3
    grad = torch.linspace(0.1, 1.0, n, device=tables[0].device).reshape(scene.height,
                                                                        scene.width, 3)
    args = (tables[0], tables[2], tables[3], tables[4], tables[7], grad, *aux)
    bkw = dict(width=kw["width"], height=kw["height"], rows=kw["rows"],
               n_lights=tables[4].shape[0], bounces=kw["bounces"])
    return args, bkw


def _assert_bwd_close(k_vec, p_vec, n_obj, n_lights, label):
    """Each parameter group within tests/test_pallas.py:177-181's rule
    (parity.gradient_group_errors)."""
    assert torch.isfinite(k_vec).all(), label
    for group, (err, tol) in gradient_group_errors(k_vec, p_vec, n_obj, n_lights).items():
        assert err < tol, (label, group, err)


def _kernel_vs_plain_bwd(args, bkw, label):
    before = render_bwd.launches
    k_vec = render_bwd(*args, **bkw)
    torch.cuda.synchronize()
    assert render_bwd.launches == before + 1
    p_vec = render_bwd_plain(*args, **bkw)
    _assert_bwd_close(k_vec, p_vec, args[0].shape[0], bkw["n_lights"], label)
    return k_vec


@pytest.mark.parametrize("name", SCENES)
def test_bwd_kernel_matches_plain(cuda, name):
    """K2 against render_bwd_plain on the same (kernel) aux, so knife-edge
    root choices of the two forwards do not enter; reflection_test runs its
    own max_reflections chain."""
    scene = _scene(name, cuda)
    for pose in POSES:
        args, bkw = _bwd_case(scene, _camera(pose, cuda))
        _kernel_vs_plain_bwd(args, bkw, (name, pose))


def _many_lights_scene(n_lights, device, width=24, height=8):
    """tests/test_degenerate.py's fan of directional lights over a sphere
    and a plane."""
    objects = [Object(tsurface.sphere((0.0, 0.0, 6.0), 2.0), 0.0, np.float32([0.8, 0.3, 0.2])),
               Object(tsurface.plane((0.0, -3.0, 0.0), (0.0, 1.0, 0.0)), 0.0,
                      np.float32([0.2, 0.6, 0.9]))]
    lights = []
    for i in range(n_lights):
        ang = 2.0 * np.pi * i / n_lights
        lights.append(tlight.directional(
            0.08, (np.cos(ang) * 0.5, -1.0, np.sin(ang) * 0.5 + 0.3),
            (1.0, 1.0 - 0.5 * (i % 3) / 2.0, 0.5 + 0.5 * (i % 2))))
    return ttt.build_scene(width, height, 60.0, objects, lights, bg_color=(0.1, 0.1, 0.1),
                           device=device)


@pytest.mark.parametrize("case", ["31_lights", "deep_chain", "global_rows"])
def test_bwd_kernel_edges(cuda, case):
    """31 lights (the last the i32 mask holds); a chain deeper than the
    kernel's per-thread stage array (rebuilt stages); more accumulator rows
    than shared memory holds (the warp copies in global scratch; the tables
    leave too little room for columns, so every row is summed by warp
    reductions)."""
    if case == "31_lights":
        scene = _many_lights_scene(31, cuda, 48, 32)
        args, bkw = _bwd_case(scene, _camera(POSES[0], cuda), polish_iters=2)
    elif case == "deep_chain":
        # a floor and a ceiling that both reflect: rays bounce to the cap
        objects = [Object(tsurface.plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0)), 0.7,
                          np.float32([0.9, 0.8, 0.7])),
                   Object(tsurface.plane((0.0, 2.0, 0.0), (0.0, -1.0, 0.0)), 0.6,
                          np.float32([0.6, 0.7, 0.9])),
                   Object(tsurface.sphere((0.5, 0.0, 9.0), 1.0), 0.3, np.float32([0.9, 0.2, 0.2]))]
        lights = [tlight.directional(1.0, (0.3, -1.0, 0.4), (1, 1, 1)),
                  tlight.spherical(200.0, (0.0, 1.5, 6.0), (1, 1, 1))]
        scene = ttt.build_scene(48, 36, 60.0, objects, lights, max_reflections=11,
                                device=cuda)
        args, bkw = _bwd_case(scene, _camera(((0.0, 0.0, 0.0), 90.0, -10.0), cuda))
        assert bkw["bounces"] == 11
        assert (args[7][8:] >= 0).any()  # some pixel reaches a rebuilt stage
    else:
        rng = np.random.default_rng(11)
        objects = [Object(tsurface.sphere(rng.uniform(-6, 6, 3) + [0, 0, 20], 0.4), 0.0,
                          rng.uniform(0, 1, 3).astype(np.float32)) for _ in range(600)]
        lights = [tlight.directional(1.0, (0.3, -1.0, 0.4), (1, 1, 1)),
                  tlight.spherical(400.0, (0.0, 8.0, 10.0), (1, 1, 1))]
        scene = ttt.build_scene(32, 24, 60.0, objects, lights, device=cuda)
        args, bkw = _bwd_case(scene, _camera(POSES[0], cuda))
        assert acc_layout(600, 2)[-1] * 4 * 4 > 200 * 1024  # 4 warp copies
        assert bwd_plan(32, 24, 600, 2, 0)[0] == "warp"
    _kernel_vs_plain_bwd(args, bkw, case)


def test_bwd_deterministic_and_large(cuda):
    """Two backward calls give the same bits; 20spheres (631 accumulator
    rows, 19 lights) at 320x240 matches the plain version."""
    scene = _scene("20spheres", cuda, 320, 240)
    args, bkw = _bwd_case(scene, _camera(POSES[0], cuda))
    assert acc_layout(20, 19)[-1] == 631
    first = _kernel_vs_plain_bwd(args, bkw, "20spheres 320x240")
    assert torch.equal(render_bwd(*args, **bkw), first)
    refl = _scene("reflection_test", cuda)
    args, bkw = _bwd_case(refl, _camera(POSES[1], cuda))
    assert torch.equal(render_bwd(*args, **bkw), render_bwd(*args, **bkw))


def test_backward_launches_once_each(cuda):
    """One .backward() through render_image_kernel: exactly one render_fwd
    launch (with aux) and one render_bwd launch; gradients reach every
    differentiable table."""
    scene = _scene("dingdong", cuda)
    fields = ("coefs", "colors", "reflection", "light_p", "light_color", "bg_color",
              "tan_half_fov")
    leaves = {f: getattr(scene, f).clone().requires_grad_() for f in fields}
    scene = dataclasses.replace(scene, **leaves)
    cam = _camera(POSES[1], cuda)
    cam_leaves = [t.requires_grad_() for t in (cam.position, cam.yaw_deg, cam.pitch_deg)]
    f0, b0 = render_fwd.launches, render_bwd.launches
    image = ttt.render_image_kernel(scene, cam)
    (image * torch.linspace(0.1, 1.0, image.numel(), device=cuda).reshape(image.shape)).sum() \
        .backward()
    torch.cuda.synchronize()
    assert (render_fwd.launches - f0, render_bwd.launches - b0) == (1, 1)
    for name, leaf in [*leaves.items(), *zip(("position", "yaw", "pitch"), cam_leaves)]:
        assert leaf.grad is not None and torch.isfinite(leaf.grad).all(), name
    assert float(leaves["coefs"].grad.abs().max()) > 0


# --- the forward's instantiations and the backward's row placements ---

FWD_COUNTS = [(3, 3, 1), (2, 2, 2), (0, 3, 1)]  # polish, screen, shadow


@pytest.mark.parametrize("name", SCENES)
def test_fwd_instantiations_match_plain(cuda, name):
    """Each instantiation of the forward kernel against the plain version:
    the main counts (polish 3, screen 3, shadow 1; bounces 0 runs "main",
    reflection_test's chain "main_chain") and the generic one with other
    counts (2/2/2, and polish 0); the launch is counted under the
    instantiation that ran."""
    scene = _scene(name, cuda)
    tables, kw = pack_frame(scene, _camera(POSES[1], cuda), 0, scene.height)
    for polish, screen, shadow in FWD_COUNTS:
        case = {**kw, "polish_iters": polish, "screen_iters": screen, "shadow_iters": shadow}
        want = ("generic" if (polish, screen, shadow) != (3, 3, 1)
                else "main" if kw["bounces"] == 0 else "main_chain")
        assert fwd_variant(polish, screen, shadow, kw["bounces"]) == want
        before = dict(render_fwd.launches_by_variant)
        out = render_fwd(*tables, **case).cpu().numpy()
        torch.cuda.synchronize()
        assert render_fwd.launches_by_variant[want] == before[want] + 1
        plain = render_fwd_plain(*tables, **case).cpu().numpy()
        assert np.isfinite(out).all()
        assert bad_pixel_fraction(out, plain) <= MAX_BAD_VS_PLAIN, (name, case)


def test_fwd_launcher_refuses_a_variant_that_does_not_fit(cuda):
    """The main instantiations compile the counts in: asked for other
    counts, or "main" with a chain, the launcher returns
    cudaErrorInvalidValue (1) and launches nothing."""
    scene = _scene("reflection_test", cuda)
    tables, kw = pack_frame(scene, _camera(POSES[0], cuda), 0, scene.height)
    out = torch.empty((kw["rows"], kw["width"], 3), device=cuda)
    lib = _build.load("render_fwd")
    stream = torch.cuda.current_stream().cuda_stream
    for polish, variant in ((2, "main_chain"), (3, "main")):
        rc = lib.trt_render_fwd(
            *(t.data_ptr() for t in tables), out.data_ptr(), None, None, None,
            kw["width"], kw["height"], kw["rows"], tables[0].shape[0], kw["n_cubic"],
            tables[4].shape[0], polish, kw["shadow_iters"], kw["screen_iters"], kw["bounces"],
            FWD_VARIANTS.index(variant), stream)
        assert rc == 1, (polish, variant)


def test_main_path_launch_counts(cuda):
    """render_image_kernel runs "main" on dingdong, "main_chain" on
    reflection_test and "generic" with polish 2."""
    for name, polish, want in (("dingdong", 3, "main"), ("reflection_test", 3, "main_chain"),
                               ("dingdong", 2, "generic")):
        before = dict(render_fwd.launches_by_variant)
        ttt.render_image_kernel(_scene(name, cuda), polish_iters=polish)
        after = render_fwd.launches_by_variant
        assert {k: after[k] - before[k] for k in after} == {
            k: int(k == want) for k in after}, (name, polish)


@pytest.mark.parametrize("name,placement", [("dingdong", "columns"),
                                            ("reflection_test", "columns"),
                                            ("20spheres", "light_columns")])
def test_bwd_placements_match_plain(cuda, name, placement):
    """The row placement the launcher picks (every row in the threads'
    columns where they fit, the light rows only on 20spheres; the warp
    placement is the 600-object case of test_bwd_kernel_edges) against the
    plain version, counted under that placement, bitwise the same on a
    second call."""
    scene = _scene(name, cuda)
    args, bkw = _bwd_case(scene, _camera(POSES[1], cuda))
    assert bwd_plan(bkw["width"], bkw["rows"], args[0].shape[0], bkw["n_lights"],
                    bkw["bounces"])[0] == placement
    before = render_bwd.launches_by_placement[placement]
    vec = _kernel_vs_plain_bwd(args, bkw, (name, placement))
    assert render_bwd.launches_by_placement[placement] == before + 1
    assert torch.equal(render_bwd(*args, **bkw), vec)


def test_bwd_ragged_grid(cuda):
    """1000x37 pixels fill no whole number of blocks (of 64 or 128 threads)
    or of waves: the kernel against the plain version."""
    scene = _scene("dingdong", cuda, 1000, 37)
    args, bkw = _bwd_case(scene, _camera(POSES[0], cuda))
    placement, blocks, _ = bwd_plan(1000, 37, args[0].shape[0], bkw["n_lights"],
                                    bkw["bounces"])
    assert (1000 * 37) % (blocks * 64) != 0
    assert placement == "columns"
    _kernel_vs_plain_bwd(args, bkw, "1000x37")


# --- the plain pipeline, the gradient fallback and the CLI on the card ---

@pytest.mark.parametrize("name", SCENES)
def test_pipeline_on_card_matches_cpu(cuda, name):
    """The FAST pipeline on the card against the same call on the CPU: at
    most 1e-3 of the pixels differ by more than 2/255 (the card's math
    library rounds cos, acos and pow in other last bits)."""
    gpu = ttt.render_image(_scene(name, cuda))
    assert gpu.device.type == "cuda"
    cpu = ttt.render_image(_scene(name, "cpu"))
    assert bad_pixel_fraction(gpu.cpu().numpy(), cpu.numpy()) <= MAX_BAD_VS_PLAIN


def test_ray_poly_coeffs_ignores_tf32(cuda):
    """The monomial contraction is products and sums: with TF32 matmuls
    allowed (which visibly changes a matmul of the same basis) it gives the
    same bits as without."""
    from tpu_ray_tracer_torch.ops.poly import ray_basis, ray_poly_coeffs

    gen = torch.Generator(device="cpu").manual_seed(20261016)
    coefs = torch.randn(7, 20, generator=gen).to(cuda)
    origin = torch.randn(4096, 3, generator=gen).to(cuda)
    d = torch.nn.functional.normalize(torch.randn(4096, 3, generator=gen), dim=-1).to(cuda)
    tf32, prec = torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        strict = ray_poly_coeffs(coefs, origin, d)
        mm_strict = ray_basis(origin, d)[1] @ coefs.T
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        loose = ray_poly_coeffs(coefs, origin, d)
        mm_loose = ray_basis(origin, d)[1] @ coefs.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(prec)
    assert not torch.equal(mm_strict, mm_loose)  # the switch is live
    for a, b in zip(strict, loose):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["33_lights", "no_objects"])
def test_fallback_gradient_launches(cuda, case):
    """A gradient the fused backward cannot encode: one render_fwd launch
    (the main instantiation, no aux), no render_bwd, and the gradient of
    the pipeline's own autograd on the card."""
    if case == "33_lights":
        scene = _many_lights_scene(33, cuda, 48, 32)
    else:
        scene = ttt.build_scene(48, 32, 60.0, [], [tlight.directional(
            1.0, (0.0, -1.0, 0.0), (1.0, 1.0, 1.0))], bg_color=(0.3, 0.6, 0.9), device=cuda)
    light_color = scene.light_color.clone().requires_grad_()
    scene = dataclasses.replace(scene, light_color=light_color)
    f0, b0, m0 = render_fwd.launches, render_bwd.launches, render_fwd.launches_by_variant["main"]
    ttt.render_image_kernel(scene).sum().backward()
    torch.cuda.synchronize()
    assert (render_fwd.launches - f0, render_bwd.launches - b0) == (1, 0)
    assert render_fwd.launches_by_variant["main"] == m0 + 1
    assert torch.isfinite(light_color.grad).all()
    if case == "no_objects":  # the frame does not read the lights
        assert not light_color.grad.any()
        return
    ref = light_color.detach().clone().requires_grad_()
    config = ttt.RenderConfig("float32", 3, 0, chunk_px=None)
    ttt.render_image(dataclasses.replace(scene, light_color=ref), None, config).sum().backward()
    torch.testing.assert_close(light_color.grad, ref.grad, rtol=1e-5, atol=1e-7)


def test_cli_render_kernel_launches_main_once(cuda, tmp_path):
    """``render --backend kernel`` on the card: one render_fwd launch, of
    the main instantiation, and a finite frame."""
    from tpu_ray_tracer_torch.cli import main

    out = tmp_path / "dingdong.npy"
    before = dict(render_fwd.launches_by_variant)
    assert main(["render", str(SCENE_DIR / "dingdong.yml"), "--backend", "kernel", "--size",
                 "64", "48", "--check", "-o", str(out)]) == 0
    torch.cuda.synchronize()
    after = render_fwd.launches_by_variant
    assert {k: after[k] - before[k] for k in after} == {"main": 1, "main_chain": 0,
                                                        "generic": 0}
    img = np.load(out)
    assert img.shape == (48, 64, 3) and np.isfinite(img).all()


def test_argmin_ties_on_card(cuda):
    """torch.argmin on the card returns the first of tied minima, as the
    pipeline's nearest-hit selection needs (reference strict-< scan)."""
    t = torch.ones(100003, 20, device=cuda)
    t[:, 7:] = 0.5
    assert (torch.argmin(t, dim=-1) == 7).all()


# --- inverse rendering and soft visibility on the card ---

def test_fit_step_launches_each_kernel_once(cuda):
    """A kernel-route train step: one render_fwd launch with aux and one
    render_bwd launch; the parameters and the Adam state stay on the card."""
    from tpu_ray_tracer_torch.diff.inverse import (InverseProblem, extract_params,
                                                   make_train_step)

    scene = _scene("dingdong", cuda)
    with torch.no_grad():
        target = ttt.render_image_kernel(scene, polish_iters=2, bounces=0)
    perturbed = dataclasses.replace(scene, light_color=scene.light_color * 0.6)
    problem = InverseProblem(scene_template=perturbed,
                             config=ttt.RenderConfig("float32", 2, chunk_px=None),
                             param_fields=("light_color",), learning_rate=5e-2, backend="kernel")
    params = extract_params(perturbed.astype(torch.float32), problem.param_fields)
    optimizer = problem.optimizer(params)
    step = make_train_step(problem)
    cam = _camera(POSES[0], cuda)
    losses = []
    for _ in range(2):
        f0, a0, b0 = render_fwd.launches, render_fwd.launches_save_aux, render_bwd.launches
        losses.append(step(params, optimizer, cam, target))
        torch.cuda.synchronize()
        assert (render_fwd.launches - f0, render_fwd.launches_save_aux - a0,
                render_bwd.launches - b0) == (1, 1, 1)
    assert np.isfinite(losses).all() and losses[1] < losses[0]
    state = optimizer.state[params["light_color"]]
    assert params["light_color"].device.type == state["exp_avg"].device.type == "cuda"


def test_row_block_backward_equals_one_shot(cuda):
    """The pipeline route's row-block backward against one shot on
    dingdong 640x480 at pitch 5: the loss within 1e-5 and each gradient
    within 1e-4 of its largest entry (the f32 summation order differs)."""
    from tpu_ray_tracer_torch.diff.inverse import (InverseProblem, extract_params,
                                                   make_loss_fn, param_tensors)

    scene = _scene("dingdong", cuda, 640, 480)
    cam = _camera(((0.0, 0.0, 0.0), 90.0, 5.0), cuda)
    with torch.no_grad():
        target = ttt.render_image_kernel(scene, cam) * 0.9
    problem = InverseProblem(scene_template=scene,
                             config=ttt.RenderConfig("float32", 3, chunk_px=None),
                             param_fields=("coefs", "light_color", "camera"))
    loss_fn = make_loss_fn(problem)
    one = extract_params(scene, problem.param_fields, camera=cam)
    whole = loss_fn(one, None, target)
    whole.backward()
    blocks = extract_params(scene, problem.param_fields, camera=cam)
    loss_fn.block_rows = 100
    value = loss_fn.backward(blocks, None, target)
    assert float(value) == pytest.approx(float(whole.detach()), rel=1e-5)
    for a, b in zip(param_tensors(one), param_tensors(blocks)):
        scale = float(a.grad.abs().max())
        assert scale > 0
        assert float((a.grad - b.grad).abs().max()) <= 1e-4 * scale


def test_soft_render_on_card_matches_cpu(cuda):
    """``render_rays_soft`` on clebsch 64x48 (tau 0.15) on the card against
    the same call on the CPU: at most 1e-3 of the pixels apart by more than
    2/255, and the gradient of the image sum with respect to the
    coefficients and light colours within tests/test_pallas.py:174-181's
    rule."""
    from tpu_ray_tracer_torch.diff.soft import render_rays_soft
    from tpu_ray_tracer_torch.ops import camera as camera_ops

    results = []
    for device in (cuda, torch.device("cpu")):
        scene = _scene("clebsch", device).astype(torch.float32)
        leaves = [scene.coefs.clone().requires_grad_(),
                  scene.light_color.clone().requires_grad_()]
        scene = dataclasses.replace(scene, coefs=leaves[0], light_color=leaves[1])
        rot, eye = camera_ops.camera_frame(_camera(POSES[0], device))
        dirs = camera_ops.pixel_directions(rot, scene.width, scene.height, scene.aspect_ratio,
                                           scene.tan_half_fov)
        img = render_rays_soft(scene, eye.expand(dirs.shape), dirs, polish_iters=2, tau=0.15)
        img.sum().backward()
        results.append((img.detach().cpu().numpy(), [t.grad.cpu().numpy() for t in leaves]))
    (gpu_img, gpu_grads), (cpu_img, cpu_grads) = results
    assert np.isfinite(gpu_img).all()
    assert bad_pixel_fraction(gpu_img, cpu_img) <= MAX_BAD_VS_PLAIN
    for got, ref in zip(gpu_grads, cpu_grads):
        scale = max(np.abs(ref).max(), 1e-6)
        tol = 2e-3 if np.abs(ref).max() > 1.0 else 2e-2
        assert np.abs(got - ref).max() / scale < tol


def test_sharded_world_of_one_over_nccl(cuda, tmp_path):
    """``render_image_sharded`` over an NCCL process group of one rank
    (kernel route, one gather) equals the unsharded frame bit for bit, and
    a sharded train step equals the one without a process group."""
    import datetime

    import torch.distributed as dist

    from tpu_ray_tracer_torch.diff.inverse import (InverseProblem, extract_params,
                                                   make_train_step)
    from tpu_ray_tracer_torch.parallel.sharding import make_mesh, render_image_sharded

    scene = _scene("dingdong", cuda, 128, 72)
    cam = _camera(POSES[0], cuda)
    config = ttt.RenderConfig(polish_iters=3, chunk_px=None)
    with torch.no_grad():
        single = ttt.render_image_kernel(scene, cam)
    problem = InverseProblem(dataclasses.replace(scene, light_color=scene.light_color * 0.6),
                             param_fields=("light_color",), backend="kernel")

    def step(group=None):
        params = extract_params(problem.scene_template, problem.param_fields)
        loss = make_train_step(problem, group)(params, problem.optimizer(params), cam, single)
        return loss, params["light_color"].detach()

    loss, light = step()
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        group = make_mesh(cuda).group
        with torch.no_grad():
            sharded = render_image_sharded(scene, cam, config, group=group)
        sharded_loss, sharded_light = step(group)
    finally:
        dist.destroy_process_group()
    assert torch.equal(sharded, single)
    assert sharded_loss == loss and torch.equal(sharded_light, light)


def test_native_loader_on_card(cuda):
    """The native loader's default device is the card, and its dingdong
    tables there equal the Python loader's."""
    from tpu_ray_tracer_torch import native

    path = SCENE_DIR / "dingdong.yml"
    a, b = native.load_from_file(path), ttt.load_from_file(path)
    for f in ("coefs", "colors", "reflection", "light_p", "light_color", "light_is_spherical",
              "bg_color", "tan_half_fov"):
        got = getattr(a, f)
        assert got.device.type == "cuda" and torch.equal(got, getattr(b, f)), f
