"""The CUDA kernels against their plain PyTorch versions, on the card: the
forward (with and without its per-stage aux) and the backward; the plain
pipeline, the gradient fallback and the CLI on the card; the fit's
kernel-route step, its row-block pipeline backward and the soft render; the
pipeline's root solve and the soft render's branch B against their plain
versions; and the row-sharded frame
and step over an NCCL group of one rank, the native scene loader on the
card, the CUDA graphs of frames, gradients and fit steps against the eager
paths (the kernel route's and the pipeline
route's, and the bound on the bytes the graphs keep), and the port's bench
at full size.

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
from tpu_ray_tracer_torch.render.kernel_backend import (_host_half, pack_frame, PackedRender,
                                                        render_rows_kernel)
from tpu_ray_tracer_torch.render.pack_kernel import (GRAD_FIELDS, pack_tables, pack_tables_plain,
                                                     pack_vjp, pack_vjp_plain)

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
    plan = bwd_plan(bkw["width"], bkw["rows"], args[0].shape[0], bkw["n_lights"],
                    bkw["bounces"])
    assert (plan[0], plan[3]) == (placement, "shared")
    layout = f"{placement}.shared"
    before = render_bwd.launches_by_placement[layout]
    vec = _kernel_vs_plain_bwd(args, bkw, (name, placement))
    assert render_bwd.launches_by_placement[layout] == before + 1
    assert torch.equal(render_bwd(*args, **bkw), vec)


def test_bwd_ragged_grid(cuda):
    """1000x37 pixels fill no whole number of blocks (of 64 or 128 threads)
    or of waves: the kernel against the plain version."""
    scene = _scene("dingdong", cuda, 1000, 37)
    args, bkw = _bwd_case(scene, _camera(POSES[0], cuda))
    placement, blocks, _, _ = bwd_plan(1000, 37, args[0].shape[0], bkw["n_lights"],
                                       bkw["bounces"])
    assert (1000 * 37) % (blocks * 64) != 0
    assert placement == "columns"
    _kernel_vs_plain_bwd(args, bkw, "1000x37")


# --- the packing kernels ---

PACK_POSES = POSES + [((0.5, -1.0, 2.0), 91.0, 2.0)]
CAMERA_GRAD_RTOL = 1e-5  # yaw and pitch: the same closed form, the card's sinf/cosf both sides


def _bits(t):
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("name", SCENES)
def test_pack_tables_match_plain(cuda, name):
    """The packing kernel's 8 tables bit for bit the plain version's (torch
    ops on the card), full-size scenes at 3 poses, f32 and f64 cameras, row0
    0 and half the height (the second of two row-sharded ranks)."""
    scene = ttt.load_from_file(SCENE_DIR / f"{name}.yml", device=cuda)
    host = _host_half(scene, 3, None, None)
    for pose in PACK_POSES:
        for dtype in (torch.float32, torch.float64):
            pos, yaw, pitch = pose
            cam = ttt.Camera(*(torch.tensor(v, dtype=dtype, device=cuda) for v in (pos, yaw, pitch)))
            for row0 in (0, scene.height // 2):
                before = pack_tables.launches
                got = pack_tables(scene, cam, host["slots"], n_cubic=host["n_cubic"], row0=row0)
                torch.cuda.synchronize()
                assert pack_tables.launches == before + 1
                want = pack_tables_plain(scene, cam, host["slots"], n_cubic=host["n_cubic"],
                                         row0=row0)
                for i, (g, w) in enumerate(zip(got, want)):
                    assert g.dtype == w.dtype and g.shape == w.shape, (name, i)
                    assert torch.equal(_bits(g), _bits(w)), (name, pose, dtype, row0, i)


def _seeded_vec(scene, seed):
    n = acc_layout(scene.n_objects, scene.n_lights)[-1]
    vec = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    return torch.tensor(vec, device=scene.coefs.device)


def _assert_grads_close(got, want, label):
    """Every table's gradient bit for bit; the camera angles' within
    CAMERA_GRAD_RTOL of the larger magnitude."""
    for field, g, w in zip(GRAD_FIELDS, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (label, field)
        if field in ("yaw_deg", "pitch_deg"):
            scale = max(float(w.abs()), 1e-30)
            assert float((g - w).abs()) <= CAMERA_GRAD_RTOL * scale, (label, field, g, w)
        else:
            assert torch.equal(g, w), (label, field)


@pytest.mark.parametrize("name", SCENES)
def test_pack_vjp_matches_plain(cuda, name):
    """The packing VJP kernel against its plain version on a seeded
    gradient vector, and a gradient left out where it is not wanted."""
    scene = ttt.load_from_file(SCENE_DIR / f"{name}.yml", device=cuda)
    gather = _host_half(scene, 3, None, None)["slots"][0]
    cam = _camera(PACK_POSES[2], cuda)
    vec = _seeded_vec(scene, 15)
    before = pack_vjp.launches
    got = pack_vjp(vec, gather, scene, cam)
    torch.cuda.synchronize()
    assert pack_vjp.launches == before + 1
    _assert_grads_close(got, pack_vjp_plain(vec, gather, scene, cam), name)
    wanted = [f in ("colors", "yaw_deg") for f in GRAD_FIELDS]
    some = pack_vjp(vec, gather, scene, cam, wanted=wanted)
    assert [g is not None for g in some] == wanted
    assert torch.equal(some[1], got[1]) and torch.equal(some[8], got[8])


@pytest.mark.parametrize("name", ["dingdong", "reflection_test", "20spheres"])
def test_frame_gradients_match_packed_render(cuda, name):
    """A differentiable frame through the packing kernels (pack_frame and
    pack_vjp, one launch each) against PackedRender with autograd through
    the plain packing: every table's gradient bit for bit, tan_half_fov's
    and the camera's within 1e-5 of their group's largest magnitude (a
    closed form against autograd's rounding)."""
    scene = _scene(name, cuda, 96, 64)
    cam = _camera(PACK_POSES[2], cuda)
    ramp = torch.linspace(0.1, 1.0, 64 * 96 * 3, device=cuda).reshape(64, 96, 3)

    def leaves():
        sl = {f: getattr(scene, f).detach().clone().requires_grad_() for f in GRAD_FIELDS[:7]}
        cl = [getattr(cam, f).detach().clone().requires_grad_() for f in GRAD_FIELDS[7:]]
        return dataclasses.replace(scene, **sl), ttt.Camera(*cl), [*sl.values(), *cl]

    s1, c1, l1 = leaves()
    before = (pack_tables.launches, pack_vjp.launches)
    (ramp * render_rows_kernel(s1, c1, 0, 64)).sum().backward()
    torch.cuda.synchronize()
    assert (pack_tables.launches - before[0], pack_vjp.launches - before[1]) == (1, 1)
    s2, c2, l2 = leaves()
    with torch.no_grad():
        _, kw = pack_frame(s2, c2, 0, 64)
    # the plain packing, differentiable, on the same tensors
    host = _host_half(s2, 3, None, None)
    tables = pack_tables_plain(s2, c2, host["slots"], n_cubic=host["n_cubic"], row0=0)
    (ramp * PackedRender.apply(*tables, kw)).sum().backward()
    for field, a, b in zip(GRAD_FIELDS, l1, l2):
        if field in ("tan_half_fov", "position", "yaw_deg", "pitch_deg"):
            scale = max(float(b.grad.abs().max()), 1e-30)
            assert float((a.grad - b.grad).abs().max()) <= 1e-5 * scale, (name, field)
        else:
            assert torch.equal(a.grad, b.grad), (name, field)


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


def test_fit_step_counts_the_bwd_layout(cuda):
    """20spheres' colour and light fit on the kernel route (20 objects, 19
    lights, 631 gradient rows): every step, graphed or not, is one render_fwd
    launch with aux and one render_bwd launch, counted under K2's
    light_columns placement with its warp copies in shared memory; the step
    replays one graph, and none of its keys runs eagerly over the byte
    bound."""
    from tpu_ray_tracer_torch.diff.inverse import (InverseProblem, extract_params,
                                                   make_train_step)
    from tpu_ray_tracer_torch.render.bwd_kernel import BWD_LAYOUTS

    scene = _scene("20spheres", cuda)
    with torch.no_grad():
        target = ttt.render_image_kernel(scene, polish_iters=2, bounces=0)
    fields = ("colors", "light_color")
    perturbed = dataclasses.replace(scene, colors=scene.colors * 0.6,
                                    light_color=scene.light_color * 0.6)
    problem = InverseProblem(scene_template=perturbed,
                             config=ttt.RenderConfig("float32", 2, chunk_px=None),
                             param_fields=fields, learning_rate=5e-2, backend="kernel")
    params = extract_params(perturbed.astype(torch.float32), fields)
    optimizer = problem.optimizer(params)
    step = make_train_step(problem)
    cam = _camera(POSES[0], cuda)
    placement, _, _, acc = bwd_plan(64, 48, 20, 19, 0)
    assert (placement, acc) == ("light_columns", "shared")
    for k in range(5):
        before = dict(render_bwd.launches_by_placement)
        a0, b0 = render_fwd.launches_save_aux, render_bwd.launches
        step(params, optimizer, cam, target)
        torch.cuda.synchronize()
        assert (render_fwd.launches_save_aux - a0, render_bwd.launches - b0) == (1, 1), k
        assert {n: render_bwd.launches_by_placement[n] - before[n] for n in BWD_LAYOUTS} == {
            n: int(n == "light_columns.shared") for n in BWD_LAYOUTS}, k
    assert step.graphs.captures == 1 and step.graphs.over_bound == 0


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


# --- the pipeline's per-object gather: select_rows' backward kernels ---

SELECT_CASES = {  # rows, objects, values a row, dtype, the plan's placement
    "clebsch": (2 * 374 * 800, 1, 20, torch.float32, "shared"),  # a soft row block, one object
    "21_objects": (2 * 48 * 640, 21, 3, torch.float32, "shared"),  # 10 lane groups a warp
    "global": (100_000, 200, 20, torch.float32, "global"),  # the warp sums past shared memory
    "golden": (64 * 48, 3, 20, torch.float64, "shared"),
}


@pytest.mark.parametrize("case", list(SELECT_CASES))
def test_select_rows_bwd_matches_index_add(cuda, case):
    """The backward's kernels against a float64 ``index_add_`` on the card,
    and the same bits from a second call. The tolerance of each entry is
    its sum of |rows| times the unit roundoff of the dtype times a bound on
    the longest chain of additions in the kernel's order: a lane's rows (at
    most its block's over 8 warps), its block's warp copies (at most 8
    warps of 32 lane groups), a reduce thread's columns and the reduce's 8
    halvings (for f64 also the reference's own serial chain of rows)."""
    import math

    from tpu_ray_tracer_torch.render.select_kernel import select_plan, select_rows_bwd

    rows, n, c, dtype, placement = SELECT_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(1800 + n)
    grad = torch.randn((rows, c), generator=g, dtype=dtype, device=cuda)
    idx = torch.randint(0, n, (rows,), generator=g, device=cuda)
    got = select_rows_bwd(grad, idx, (n, c))
    again = select_rows_bwd(grad, idx, (n, c))
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    where, blocks, _ = select_plan(rows, n, c, dtype)
    assert where == placement
    zero = torch.zeros((n, c), dtype=torch.float64, device=cuda)
    want = zero.index_add(0, idx, grad.double())
    abs_sum = zero.index_add(0, idx, grad.double().abs())
    depth = (math.ceil(rows / blocks / 8) + 1 + 8 * 32 + math.ceil(blocks / 256) + 8
             + (rows if dtype == torch.float64 else 0))
    tol = depth * torch.finfo(dtype).eps / 2 * abs_sum
    assert ((got.double() - want).abs() <= tol).all(), float(((got.double() - want).abs()
                                                              / tol).max())


@pytest.mark.parametrize("rows", [2 * 374 * 800, 2 * 226 * 800], ids=["block_374", "block_226"])
def test_select_rows_bwd_exact_at_clebsch_row_blocks(cuda, rows):
    """clebsch 800x600's two soft row blocks (374 and 226 rows of 800 rays,
    both branches), every row on its one object: a gradient of ones sums to
    the row count in every entry, and integers in [-8, 8] to the float64
    sum, exactly (every partial sum is an integer under 2**24, which f32
    holds in any order). A row dropped or counted twice fails."""
    from tpu_ray_tracer_torch.render.select_kernel import select_rows_bwd

    idx = torch.zeros(rows, dtype=torch.int64, device=cuda)
    counts = select_rows_bwd(torch.ones((rows, 20), device=cuda), idx, (1, 20))
    assert bool((counts == rows).all()), counts
    g = torch.Generator(device=cuda).manual_seed(rows)
    ints = torch.randint(-8, 9, (rows, 20), generator=g, device=cuda).float()
    want = torch.zeros((1, 20), dtype=torch.float64, device=cuda).index_add_(0, idx, ints.double())
    assert torch.equal(select_rows_bwd(ints, idx, (1, 20)).double(), want)


@pytest.mark.parametrize("idx_kind", ["n", "2xn", "one_object"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("c", [20, 3, 1])
@pytest.mark.parametrize("n", [1, 3, 21])
def test_select_rows_on_card_matches_indexing(cuda, n, c, dtype, idx_kind):
    """``select_rows`` on a CUDA table that requires grad: the forward is
    ``table[idx]`` bit for bit, and with an integer cotangent (whose sums
    are exact in any order) the kernel's gradient equals autograd's own
    through ``table[idx]`` bit for bit, in one ``select_rows`` launch;
    without a gradient, or on the CPU, it launches nothing. C = 1 is the
    reflection ratios' [N] table; idx of shape [n], [2, n], or [2, n] with
    every row on one object."""
    from tpu_ray_tracer_torch.render.select_kernel import select_rows

    g = torch.Generator(device=cuda).manual_seed(n * 100 + c)
    shape = (n,) if c == 1 else (n, c)
    idx_shape = (37,) if idx_kind == "n" else (2, 37)
    table = torch.randn(shape, generator=g, dtype=dtype, device=cuda)
    idx = (torch.zeros(idx_shape, dtype=torch.int64, device=cuda) if idx_kind == "one_object"
           else torch.randint(0, n, idx_shape, generator=g, device=cuda))
    cotangent = torch.randint(-8, 9, idx_shape + shape[1:], generator=g, device=cuda).to(dtype)
    leaf, want_leaf = table.clone().requires_grad_(), table.clone().requires_grad_()
    before = select_rows.launches
    out = select_rows(leaf, idx)
    out.backward(cotangent)
    want = want_leaf[idx]
    want.backward(cotangent)
    torch.cuda.synchronize()
    assert select_rows.launches == before + 1
    assert out.dtype == dtype and torch.equal(out.detach(), want.detach())
    assert leaf.grad.dtype == dtype and torch.equal(leaf.grad, want_leaf.grad)
    if idx_kind == "one_object" and n > 1:
        assert not leaf.grad[1:].any()
    with torch.no_grad():
        select_rows(leaf, idx)
    cpu = table.cpu().requires_grad_()
    select_rows(cpu, idx.cpu()).backward(cotangent.cpu())
    assert select_rows.launches == before + 1


# --- the pipeline's root solve: solve_roots' kernel ---

def _solve_inputs(name, device, dtype, polish, width=64, height=48):
    """{shape: (coefs, origin, dir)} of a scene's two solves as the pipeline
    makes them: ``primary``, the camera's rays [R, 3] from one eye expanded;
    ``shadow``, the shadow rays of their nearest hits (``shade_roots``), for
    the soft render's two branches stacked: origin [2, R, 1, 3] against dir
    [2, R, L, 3]."""
    from tpu_ray_tracer_torch.ops import camera as camera_ops
    from tpu_ray_tracer_torch.ops.constants import MAX_T, SHADOW_BIAS
    from tpu_ray_tracer_torch.ops.intersect import valid_hit_mask
    from tpu_ray_tracer_torch.ops.poly import normal_vector
    from tpu_ray_tracer_torch.ops.shading import shadow_ray_dirs
    from tpu_ray_tracer_torch.ops.solve_kernel import _solve_plain

    scene = _scene(name, device, width, height).astype(dtype)
    rot, eye = camera_ops.camera_frame(_camera(POSES[1], device).to(dtype, device))
    dirs = camera_ops.pixel_directions(rot, scene.width, scene.height, scene.aspect_ratio,
                                       scene.tan_half_fov).reshape(-1, 3)
    origin = eye.expand(dirs.shape)
    t = _solve_plain(scene.coefs, origin, dirs, polish)
    valid = valid_hit_mask(t)
    idx = torch.argmin(torch.where(valid, t, torch.full_like(t, MAX_T)), dim=-1)
    best = torch.where(valid.any(-1), torch.gather(t, -1, idx[:, None])[:, 0], 0.0)
    point = origin + best[:, None] * dirs
    normal = normal_vector(scene.coefs[idx], point)
    sdir, _ = shadow_ray_dirs(scene.light_p, scene.light_is_spherical, point)
    shadow_origin = (point + SHADOW_BIAS * normal)[:, None, :]
    return {"primary": (scene.coefs, origin, dirs),
            "shadow": (scene.coefs, shadow_origin.expand((2,) + shadow_origin.shape),
                       sdir.expand((2,) + sdir.shape))}


def _bit_gap(got, want):
    """(entries whose bits differ, NaN where both are NaN excepted; the
    largest gap in ulps among them)."""
    ints = torch.int64 if got.dtype == torch.float64 else torch.int32
    a, b = got.view(ints).to(torch.int64), want.view(ints).to(torch.int64)
    sign = torch.iinfo(ints).max
    a, b = torch.where(a < 0, -(a & sign), a), torch.where(b < 0, -(b & sign), b)
    differ = (a != b) & ~(got.isnan() & want.isnan())
    return int(differ.sum()), int((a - b).abs()[differ].max()) if bool(differ.any()) else 0


# (geometry dtype, polish, coefficients' dtype): FAST's and GOLDEN's, and f64
# coefficients under an f32 configuration (f64 parameters) and the reverse
SOLVE_CASES = ([(torch.float32, polish, torch.float32) for polish in range(4)]
               + [(torch.float64, 0, torch.float64), (torch.float32, 3, torch.float64),
                  (torch.float64, 3, torch.float32)])


@pytest.mark.parametrize("name", SCENES)
def test_solve_roots_matches_plain(cuda, name):
    """The root solve's kernel against ``_solve_plain`` on the same CUDA
    tensors, bit for bit: the primary [R, 3] and the stacked shadow
    [2, R, 1, 3] x [2, R, L, 3] shapes, f32 at polish 0-3, f64 at polish 0,
    and coefficients of the other dtype than the rays' (the plain version
    promotes), one launch a call."""
    from tpu_ray_tracer_torch.ops.solve_kernel import _solve_plain, solve_roots

    for dtype, polish, coef_dtype in SOLVE_CASES:
        for shape, (coefs, origin, d) in _solve_inputs(name, cuda, dtype, polish).items():
            coefs = coefs.to(coef_dtype)
            before = solve_roots.launches
            got = solve_roots(coefs, origin, d, polish)
            torch.cuda.synchronize()
            assert solve_roots.launches == before + 1
            want = _solve_plain(coefs, origin, d, polish)
            assert got.shape == want.shape and got.dtype == want.dtype
            assert _bit_gap(got, want) == (0, 0), (name, shape, dtype, polish, coef_dtype)


def test_solve_roots_refuses_what_it_does_not_take(cuda):
    """On the card the solve launches the kernel or raises: a half-precision
    table, origin and dir of two dtypes, or tensors on two devices."""
    from tpu_ray_tracer_torch.ops.solve_kernel import solve_roots

    coefs, origin, d = _solve_inputs("clebsch", cuda, torch.float32, 2)["primary"]
    before = solve_roots.launches
    for args in [(coefs.half(), origin.half(), d.half()), (coefs, origin.double(), d),
                 (coefs.cpu(), origin, d)]:
        with pytest.raises(ValueError, match="solve_roots"):
            solve_roots(*args, 2)
    assert solve_roots.launches == before


def test_solve_roots_launches_in_a_soft_step(cuda):
    """A clebsch 800x600 soft fit step solves through ``solve_roots`` 4
    times, branch A's primary solve and the stacked shadow solve in each of
    its two row blocks, and through ``roots_excluding_pair`` twice, branch
    B's roots in each block."""
    from tpu_ray_tracer_torch.diff.inverse import extract_params, make_train_step
    from tpu_ray_tracer_torch.render import graphs

    problem, target = _pipeline_fit("clebsch", ("coefs", "light_color"), cuda, soft_tau=0.15,
                                    size=(800, 600))
    params = extract_params(problem.scene_template.astype(torch.float32), problem.param_fields)
    step = make_train_step(problem)
    before = graphs.launch_counts()
    with graphs.eager():
        loss = step(params, problem.optimizer(params), _camera(POSES[0], cuda), target, 0.15)
    assert np.isfinite(loss)
    after = graphs.launch_counts()
    assert after["solve_roots"] - before["solve_roots"] == 4
    assert after["roots_excluding_pair"] - before["roots_excluding_pair"] == 2


# --- the soft render's branch B: roots_excluding_pair's kernel ---

# (geometry dtype, polish, coefficients' dtype): f32 at polish 1-3, f64 (its
# polish 0 polishes once, as the plain version does), and mixed dtypes
EXCLUDING_CASES = ([(torch.float32, polish, torch.float32) for polish in (1, 2, 3)]
                   + [(torch.float64, 0, torch.float64), (torch.float32, 2, torch.float64),
                      (torch.float64, 2, torch.float32)])


def _pair_kinds(form, coefs):
    """``pair_kinds`` in each form a caller passes: None, the problem's
    tuple, its bool mask on the card, and every object cubic-class."""
    cubic = tuple((coefs[:, :10].abs() > 0).any(1).tolist())
    if form in ("none", "tuple"):
        return None if form == "none" else cubic
    mask = torch.tensor(cubic, dtype=torch.bool, device=coefs.device)
    return mask if form == "mask" else torch.ones_like(mask)


@pytest.mark.parametrize("name", SCENES)
def test_excluding_pair_matches_plain(cuda, name):
    """Branch B's kernel against ``_excluding_pair_plain`` on the same CUDA
    tensors, bit for bit: the primary [R, 3] and the stacked shadow layout,
    f32 at polish 1-3, f64, coefficients of the other dtype, each form of
    ``pair_kinds``, ``t_normal`` given and None; one launch a call."""
    from tpu_ray_tracer_torch.diff.soft import _excluding_pair_plain, _raw_roots_excluding_pair
    from tpu_ray_tracer_torch.ops.solve_kernel import roots_excluding_pair, solve_roots

    for dtype, polish, coef_dtype in EXCLUDING_CASES:
        for shape, (coefs, origin, d) in _solve_inputs(name, cuda, dtype, polish).items():
            coefs = coefs.to(coef_dtype)
            t_normal = solve_roots(coefs, origin, d, polish)
            for form in ("none", "tuple", "mask", "all_cubic"):
                kinds = _pair_kinds(form, coefs)
                for given in (t_normal, None):
                    before = roots_excluding_pair.launches
                    got = _raw_roots_excluding_pair(coefs, origin, d, polish, kinds, given)
                    torch.cuda.synchronize()
                    assert roots_excluding_pair.launches == before + 1
                    want = _excluding_pair_plain(coefs, origin, d, polish, kinds, given)
                    assert got.shape == want.shape and got.dtype == want.dtype
                    assert _bit_gap(got, want) == (0, 0), (
                        name, shape, dtype, polish, coef_dtype, form, given is None)


@pytest.mark.parametrize("block", [0, 1])
def test_excluding_pair_exact_at_soft_row_blocks(cuda, block, monkeypatch):
    """At clebsch 800x600's soft row blocks, as ``Loss.render_rows`` calls
    it (374 rows of 800 rays, then 226, one object, f32 polish 2, the
    problem's mask): bit for bit the plain version, one launch a block."""
    from tpu_ray_tracer_torch.diff import soft
    from tpu_ray_tracer_torch.diff.inverse import Loss, extract_params

    problem, _ = _pipeline_fit("clebsch", ("coefs", "light_color"), cuda, soft_tau=0.15,
                               size=(800, 600))
    loss = Loss(problem)
    params = extract_params(problem.scene_template.astype(torch.float32), problem.param_fields)
    calls = []

    def record(*args):
        calls.append(args)
        return kernel(*args)

    kernel = soft.roots_excluding_pair
    monkeypatch.setattr(soft, "roots_excluding_pair", record)
    y0 = block * loss.block_rows
    with torch.no_grad():
        loss.render_rows(params, _camera(POSES[0], cuda), y0,
                         min(loss.block_rows, 600 - y0))
    assert loss.block_rows == 374 and len(calls) == 1
    coefs, origin, d, polish, kinds, t_normal = calls[0]
    assert t_normal.shape == ((374, 226)[block], 800, 1) and polish == 2
    before = kernel.launches
    got = kernel(coefs, origin, d, polish, kinds, t_normal)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = soft._excluding_pair_plain(coefs, origin, d, polish, kinds, t_normal)
    assert _bit_gap(got, want) == (0, 0)


def test_fast_frames_unchanged_by_the_solve_kernel(cuda, monkeypatch):
    """FAST frames at full size through the kernel equal those through
    ``_solve_plain`` on the card bit for bit, on all 8 scenes, so their
    bad-pixel levels against bench_goldens stay where they were (cayley
    0.003567)."""
    from tpu_ray_tracer_torch.ops import intersect, solve_kernel
    from tpu_ray_tracer_torch.render import graphs
    from tpu_ray_tracer_torch.render.pipeline import FAST_CONFIG

    levels = {}
    for name in SCENES:
        scene = ttt.load_from_file(SCENE_DIR / f"{name}.yml", device=cuda)
        with torch.no_grad(), graphs.eager():
            before = solve_kernel.solve_roots.launches
            got = ttt.render_image(scene, config=FAST_CONFIG)
            assert solve_kernel.solve_roots.launches > before
            with monkeypatch.context() as m:
                m.setattr(intersect, "solve_roots", solve_kernel._solve_plain)
                want = ttt.render_image(scene, config=FAST_CONFIG)
        assert torch.equal(got, want), name
        golden = np.load(SCENE_DIR.parent / "bench_goldens" / f"{name}.npz")["image"]
        levels[name] = bad_pixel_fraction(got.cpu().numpy(), golden)
    assert levels["cayley"] == pytest.approx(0.003567, abs=5e-7), levels


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


# --- the CUDA graphs: graphed against eager, bit for bit ---

_GRAD_FIELDS = ("coefs", "colors", "reflection", "light_p", "light_color", "bg_color",
                "tan_half_fov")


def _graph_leaves(scene, cam):
    leaves = {f: getattr(scene, f).detach().clone().requires_grad_() for f in _GRAD_FIELDS}
    cam_leaves = {f: getattr(cam, f).detach().clone().requires_grad_()
                  for f in ("position", "yaw_deg", "pitch_deg")}
    return (dataclasses.replace(scene, **leaves), ttt.Camera(**cam_leaves),
            {**leaves, **cam_leaves})


@pytest.mark.parametrize("name", ["dingdong", "reflection_test", "20spheres", "cayley"])
def test_graphed_frames_equal_eager(cuda, name):
    """A frame's first call warms up, its second captures and replays, the
    rest replay: each graphed frame equals the eager one bit for bit, with
    one render_fwd launch, and a kept frame is unchanged by later replays."""
    from tpu_ray_tracer_torch.render import graphs, kernel_backend

    kernel_backend._FRAMES.clear()
    captures = kernel_backend._FRAMES.captures
    scene = _scene(name, cuda)
    frames = []
    for k, pose in enumerate([POSES[0], POSES[0], POSES[1], ((0.3, 0.1, 0.0), 95.0, 4.0)]):
        cam = _camera(pose, cuda)
        before = render_fwd.launches
        frames.append((ttt.render_image_kernel(scene, cam), cam))
        torch.cuda.synchronize()
        assert render_fwd.launches == before + 1, k
    kept = [f.clone() for f, _ in frames]
    assert kernel_backend._FRAMES.captures == captures + 1
    for (image, cam), copy in zip(frames, kept):
        assert torch.equal(image, copy)
        with graphs.eager():
            assert torch.equal(image, ttt.render_image_kernel(scene, cam))


@pytest.mark.parametrize("name", ["dingdong", "reflection_test"])
def test_graphed_gradients_equal_eager(cuda, name):
    """Every group's gradient through the graphed forward and backward
    equals the eager one bit for bit, over warm-up, capture and replay,
    with one launch of each kernel; a backward taken after the next frame's
    forward replays its own forward first."""
    from tpu_ray_tracer_torch.render import graphs, kernel_backend

    kernel_backend._FRAMES.clear()
    captures = kernel_backend._FRAMES.captures
    scene = _scene(name, cuda)
    ramp = torch.linspace(0.1, 1.0, scene.height * scene.width * 3, device=cuda).reshape(
        scene.height, scene.width, 3)

    def grads(cam, eager=False):
        g_scene, g_cam, leaves = _graph_leaves(scene, cam)
        with graphs.eager() if eager else torch.enable_grad():
            (ramp * ttt.render_image_kernel(g_scene, g_cam)).sum().backward()
        return {k: v.grad for k, v in leaves.items()}

    for k in range(3):
        cam = _camera(((0.0, 0.0, 0.0), 90.0 + k, 5.0), cuda)
        f0, b0 = render_fwd.launches, render_bwd.launches
        got = grads(cam)
        assert (render_fwd.launches - f0, render_bwd.launches - b0) == (1, 1)
        want = grads(cam, eager=True)
        assert all(torch.equal(got[n], want[n]) for n in want), k
    assert kernel_backend._FRAMES.captures == captures + 1
    first_scene, first_cam, first = _graph_leaves(scene, _camera(POSES[0], cuda))
    image = ttt.render_image_kernel(first_scene, first_cam)
    second_scene, second_cam, _ = _graph_leaves(scene, _camera(POSES[1], cuda))
    ttt.render_image_kernel(second_scene, second_cam)
    (ramp * image).sum().backward()
    want = grads(_camera(POSES[0], cuda), eager=True)
    assert all(torch.equal(first[n].grad, want[n]) for n in want)


@pytest.mark.parametrize("name,fields", [("dingdong", ("light_color",)),
                                         ("clebsch", ("coefs", "light_color")),
                                         ("20spheres", ("colors", "light_color"))])
def test_graphed_fit_steps_equal_eager(cuda, name, fields, tmp_path):
    """Five kernel-route train steps through the step's graph give the
    losses and parameters of five eager steps with the same capturable
    Adam, bit for bit; a checkpoint resumed into a capturable Adam keeps
    its step count on the card and resumes bitwise."""
    from tpu_ray_tracer_torch.diff.inverse import (InverseProblem, extract_params,
                                                   load_checkpoint, make_train_step,
                                                   save_checkpoint)
    from tpu_ray_tracer_torch.render import graphs

    scene = _scene(name, cuda)
    with torch.no_grad():
        target = ttt.render_image_kernel(scene, polish_iters=2, bounces=0)
    perturbed = dataclasses.replace(
        scene, **{f: getattr(scene, f) * (0.97 if f == "coefs" else 0.6) for f in fields})
    problem = InverseProblem(scene_template=perturbed,
                             config=ttt.RenderConfig("float32", 2, chunk_px=None),
                             param_fields=fields, learning_rate=5e-2, backend="kernel")
    cam = _camera(POSES[0], cuda)

    def run(eager, steps=5, resume=None):
        params = extract_params(perturbed.astype(torch.float32), fields)
        optimizer = problem.optimizer(params)
        if resume is not None:
            load_checkpoint(resume, params, optimizer)
        step = make_train_step(problem)
        with graphs.eager() if eager else torch.enable_grad():
            losses = [step(params, optimizer, cam, target) for _ in range(steps)]
        return losses, params, optimizer, step

    eager_losses, eager_params, _, _ = run(True)
    losses, params, optimizer, step = run(False)
    assert optimizer.param_groups[0]["capturable"] and step.graphs.captures >= 1
    assert losses == eager_losses
    assert all(torch.equal(params[k], eager_params[k]) for k in fields)
    path = str(tmp_path / "ck.npz")
    _, half, half_opt, _ = run(False, steps=2)
    save_checkpoint(path, half, half_opt, 2)
    resumed, resumed_params, resumed_opt, _ = run(False, steps=3, resume=path)
    assert resumed == losses[2:]
    assert all(torch.equal(resumed_params[k], params[k]) for k in fields)
    assert resumed_opt.state[resumed_params[fields[0]]]["step"].device.type == "cuda"


def test_graphed_train_step_reused_with_a_new_optimizer(cuda):
    """One train step driven with a second set of parameters and a new
    capturable Adam, after its key's graph was captured with the first:
    the new optimizer's first step warms up (a capture would record Adam's
    zero-fill of its state), the next captures anew, and the five steps
    equal five eager steps of a fresh train step bit for bit."""
    from tpu_ray_tracer_torch.diff.inverse import (InverseProblem, extract_params,
                                                   make_train_step)
    from tpu_ray_tracer_torch.render import graphs

    scene = _scene("dingdong", cuda)
    with torch.no_grad():
        target = ttt.render_image_kernel(scene, polish_iters=2, bounces=0)
    perturbed = dataclasses.replace(scene, light_color=scene.light_color * 0.6)
    problem = InverseProblem(scene_template=perturbed,
                             config=ttt.RenderConfig("float32", 2, chunk_px=None),
                             param_fields=("light_color",), learning_rate=5e-2,
                             backend="kernel")
    cam = _camera(POSES[0], cuda)

    def run(step, eager=False):
        params = extract_params(perturbed.astype(torch.float32), problem.param_fields)
        optimizer = problem.optimizer(params)
        with graphs.eager() if eager else torch.enable_grad():
            losses = [step(params, optimizer, cam, target) for _ in range(5)]
        return losses, params["light_color"]

    want, want_light = run(make_train_step(problem), eager=True)
    step = make_train_step(problem)
    first, _ = run(step)
    captures = step.graphs.captures
    again, light = run(step)
    assert first == want and again == want and torch.equal(light, want_light)
    assert step.graphs.captures == captures + 1


@pytest.mark.parametrize("name", ["dingdong", "reflection_test"])
def test_graphed_pipeline_frames_equal_eager(cuda, name):
    """``render_image`` without a gradient, FAST and GOLDEN: the first call
    warms up, the second captures and replays, the rest replay; each frame
    equals the eager one bit for bit, and a kept frame is unchanged by
    later replays."""
    from tpu_ray_tracer_torch.render import graphs, pipeline

    pipeline._FRAMES.clear()
    captures = pipeline._FRAMES.captures
    scene = _scene(name, cuda)
    for config in (ttt.FAST_CONFIG, ttt.GOLDEN_CONFIG):
        frames = []
        with torch.no_grad():
            for pose in [POSES[0], POSES[0], POSES[1], ((0.3, 0.1, 0.0), 95.0, 4.0)]:
                cam = _camera(pose, cuda)
                frames.append((ttt.render_image(scene, cam, config), cam))
            kept = [f.clone() for f, _ in frames]
            for (image, cam), copy in zip(frames, kept):
                assert torch.equal(image, copy)
                with graphs.eager():
                    assert torch.equal(image, ttt.render_image(scene, cam, config))
    assert pipeline._FRAMES.captures == captures + 2 and pipeline._FRAMES.over_bound == 0


def _pipeline_fit(name, fields, cuda, soft_tau=None, size=(64, 48)):
    from tpu_ray_tracer_torch.diff.inverse import InverseProblem

    scene = _scene(name, cuda, *size)
    with torch.no_grad():
        target = ttt.render_image_kernel(scene, polish_iters=2, bounces=0)
    perturbed = dataclasses.replace(
        scene, **{f: getattr(scene, f) * (0.97 if f == "coefs" else 0.6) for f in fields})
    return InverseProblem(scene_template=perturbed,
                          config=ttt.RenderConfig("float32", 2, chunk_px=None),
                          param_fields=fields, learning_rate=5e-2, backend="torch",
                          soft_tau=soft_tau), target


@pytest.mark.parametrize("case", ["soft", "hard"])
def test_graphed_pipeline_fit_steps_equal_eager(cuda, case):
    """Five pipeline-route train steps through the step's graph (the soft
    loss annealed by ``tau_schedule``, or the hard pipeline) give the
    losses and parameters of five eager steps with the same capturable
    Adam, bit for bit, through one capture, with no render_fwd or
    render_bwd launch; the soft steps' coefficient gathers take their
    gradient through one ``select_rows`` launch a step, in both, and each
    step solves its roots in two ``solve_roots`` launches (the primary and
    the shadow solve; the soft render's are branch A's and both branches'
    shadows) and, soft, branch B's in one ``roots_excluding_pair`` launch."""
    from tpu_ray_tracer_torch.diff.inverse import extract_params, make_train_step, tau_schedule
    from tpu_ray_tracer_torch.render import graphs
    from tpu_ray_tracer_torch.render.select_kernel import select_rows
    from tpu_ray_tracer_torch.ops.solve_kernel import roots_excluding_pair, solve_roots

    if case == "soft":
        fields, taus = ("coefs", "light_color"), tau_schedule(0.15, 0.05, 5)
        problem, target = _pipeline_fit("clebsch", fields, cuda, soft_tau=0.15)
    else:
        fields, taus = ("light_color",), [None] * 5
        problem, target = _pipeline_fit("dingdong", fields, cuda)
    cam = _camera(POSES[0], cuda)

    def run(eager):
        params = extract_params(problem.scene_template.astype(torch.float32), fields)
        optimizer = problem.optimizer(params)
        step = make_train_step(problem)
        with graphs.eager() if eager else torch.enable_grad():
            losses = [step(params, optimizer, cam, target, tau) for tau in taus]
        return losses, params, step

    s0, r0, e0 = select_rows.launches, solve_roots.launches, roots_excluding_pair.launches
    want, want_params, _ = run(True)
    # one row block a step, whose coefficient gather's backward is the kernel (soft)
    gathers = 5 if case == "soft" else 0
    assert select_rows.launches - s0 == gathers
    assert solve_roots.launches - r0 == 2 * 5
    assert roots_excluding_pair.launches - e0 == gathers
    a0, b0, s0 = render_fwd.launches_save_aux, render_bwd.launches, select_rows.launches
    r0, e0 = solve_roots.launches, roots_excluding_pair.launches
    losses, params, step = run(False)
    assert (render_fwd.launches_save_aux - a0, render_bwd.launches - b0) == (0, 0)
    assert select_rows.launches - s0 == gathers
    assert solve_roots.launches - r0 == 2 * 5
    assert roots_excluding_pair.launches - e0 == gathers
    assert step.graphs.captures == 1 and step.graphs.over_bound == 0
    assert losses == want
    assert all(torch.equal(params[k], want_params[k]) for k in fields)


@pytest.mark.parametrize("case", ["33_lights", "no_objects"])
def test_graphed_fallback_gradient_equals_eager(cuda, case):
    """The gradient of a scene the fused backward cannot encode, graphed:
    over warm-up, capture and replay the frame and the gradient equal the
    eager ones bit for bit, with one render_fwd launch and no render_bwd a
    frame."""
    from tpu_ray_tracer_torch.render import graphs, kernel_backend

    kernel_backend._FRAMES.clear()
    captures = kernel_backend._FRAMES.captures
    if case == "33_lights":
        scene, fields = _many_lights_scene(33, cuda, 48, 32), ("light_color", "coefs")
    else:
        scene = ttt.build_scene(48, 32, 60.0, [], [tlight.directional(
            1.0, (0.0, -1.0, 0.0), (1.0, 1.0, 1.0))], bg_color=(0.3, 0.6, 0.9), device=cuda)
        fields = ("light_color", "bg_color")

    def grads(cam, eager=False):
        leaves = {f: getattr(scene, f).detach().clone().requires_grad_() for f in fields}
        with graphs.eager() if eager else torch.enable_grad():
            image = ttt.render_image_kernel(dataclasses.replace(scene, **leaves), cam)
            image.sum().backward()
        return image.detach(), {f: leaf.grad for f, leaf in leaves.items()}

    for k in range(3):
        cam = _camera(((0.0, 0.0, 0.0), 90.0 + k, 3.0), cuda)
        f0, b0 = render_fwd.launches, render_bwd.launches
        image, got = grads(cam)
        torch.cuda.synchronize()
        assert (render_fwd.launches - f0, render_bwd.launches - b0) == (1, 0), k
        want_image, want = grads(cam, eager=True)
        assert torch.equal(image, want_image), k
        assert all(torch.equal(got[f], want[f]) for f in fields), k
    assert kernel_backend._FRAMES.captures == captures + 1


def test_pipeline_graph_byte_bound_on_card(cuda, monkeypatch):
    """With ``MAX_GRAPH_BYTES`` below a frame's warm-up bytes, the frame is
    never captured: its later calls run eagerly, counted in ``over_bound``,
    and equal the eager frame bit for bit."""
    from tpu_ray_tracer_torch.render import graphs, pipeline

    monkeypatch.setattr(pipeline, "_FRAMES", graphs.GraphCache())
    monkeypatch.setattr(graphs, "MAX_GRAPH_BYTES", 1 << 20)
    scene, cam = _scene("20spheres", cuda), _camera(POSES[0], cuda)
    with torch.no_grad():
        frames = [ttt.render_image(scene, cam) for _ in range(3)]
        with graphs.eager():
            want = ttt.render_image(scene, cam)
    assert pipeline._FRAMES.captures == 0 and pipeline._FRAMES.over_bound == 2
    assert all(torch.equal(f, want) for f in frames)


def test_bench_on_card(cuda):
    """``python -m tpu_ray_tracer_torch.bench`` at full size on the card:
    exit 0, all 12 stages measured (none failed or skipped) on the kernel
    backend, every scene within its parity gate, both kernels launched and
    each timed alone."""
    import json
    import os
    import subprocess
    import sys

    from tpu_ray_tracer_torch.parity import PARITY_GATES

    repo = SCENE_DIR.parent
    env = {k: v for k, v in os.environ.items() if not k.startswith("TRT_BENCH_")}
    proc = subprocess.run([sys.executable, "-m", "tpu_ray_tracer_torch.bench"], cwd=repo,
                          env={**env, "PYTHONPATH": str(repo)}, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    aux = line["aux"]
    assert line["metric"] == "mrays_per_s_fwd_dingdong_1280x720" and line["value"] > 0
    assert aux["forward_backend"] == "cuda" and not {"failed", "pending", "skipped"} & set(aux)
    assert set(aux["parity_bad_px_fraction"]) == set(PARITY_GATES)
    assert all(v <= PARITY_GATES[k] for k, v in aux["parity_bad_px_fraction"].items())
    assert aux["launches"]["render_fwd"] > 0 and aux["launches"]["render_bwd"] > 0
    assert len([k for k in aux if k.startswith("kernel_ms_fwd_")]) == 8
    assert len([k for k in aux if k.startswith("kernel_ms_bwd_")]) == 4
