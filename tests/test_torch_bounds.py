"""The kernels' bounds (tpu_ray_tracer_torch/render/bounds.py): the operation
counter, and the forward's and the backward's counts along the path the
call's aux records, on the CPU at a test size."""

import dataclasses

import numpy as np
import pytest
import torch

import tpu_ray_tracer_torch as ttt
from tpu_ray_tracer_torch.render import bounds
from tpu_ray_tracer_torch.render.fwd_kernel import render_fwd
from tpu_ray_tracer_torch.render.kernel_backend import pack_frame

from conftest import scene_path


def test_counter_weights():
    """add/sub/mul/min/max count 1, the math functions their SASS cost,
    selects and sign tests 0; a sum over n values n - 1."""
    x, y = torch.tensor(0.5), torch.tensor([1.0, 2.0, 3.0])
    c = bounds.SASS_COST
    assert bounds.count_ops(lambda: x * x + x) == 2
    assert bounds.count_ops(lambda: torch.clamp(x - x, min=0.0)) == 2
    assert bounds.count_ops(lambda: x / x) == c["div"]
    assert bounds.count_ops(lambda: torch.sqrt(x) + torch.rsqrt(x)) == (
        c["sqrt"] + c["rsqrt"] + 1)
    assert bounds.count_ops(lambda: torch.cos(x) * torch.pow(x, 1.0 / 3.0)) == (
        c["cos"] + c["pow"] + 1)
    assert bounds.count_ops(lambda: torch.arccos(x) + x) == c["acos"] + 1
    assert bounds.count_ops(lambda: torch.where(x > 0, -x, torch.abs(x))) == 0
    assert bounds.count_ops(lambda: y.sum()) == 2
    assert bounds.count_ops(lambda: y * 2.0) == 3


def test_bound_takes_the_larger_time():
    ms, by = bounds.bound_ms(67e9, 1.0)
    assert by == "operations" and ms == pytest.approx(1.0)
    ms, by = bounds.bound_ms(1.0, 3.35e9)
    assert by == "bytes" and ms == pytest.approx(1.0)
    # a source without FMAs: one operation an instruction, half the rate
    ms, by = bounds.bound_ms(67e9, 1.0, bounds.H100_F32_ISSUE_PER_S)
    assert by == "operations" and ms == pytest.approx(2.0)


def _frame(name, width=32, height=24):
    scene = dataclasses.replace(ttt.load_from_file(scene_path(name), device="cpu"),
                                width=width, height=height)
    tables, kw = pack_frame(scene, ttt.Camera.initial(torch.float32, "cpu"), 0, height)
    _, *aux = render_fwd(*tables, **kw, save_aux=True)
    return tables, kw, aux


@pytest.mark.parametrize("name", ["dingdong", "20spheres", "reflection_test"])
def test_fwd_work_follows_the_path(name):
    """Every pixel pays its ray generation and, per slot, the expansion and
    root solve of its primary ray; hit pixels pay more; the bytes are the
    tables and the frame (and the aux per stage)."""
    tables, kw, aux = _frame(name)
    n_px, n_obj = 32 * 24, tables[0].shape[0]
    n_cubic = kw["n_cubic"]
    c = bounds.fwd_components(3, 3, 1)
    work = bounds.fwd_work(tables, kw, aux)
    floor = n_px * (c["raygen"] + n_cubic * (c["cubic_expand_eye"] + c["cubic_roots"])
                    + (n_obj - n_cubic) * (c["quad_expand_eye"] + c["quad_roots"]))
    n_hit = int((aux[1] >= 0).sum())
    assert n_hit > 0
    assert work["ops"] >= floor + n_hit * (c["normal"] + c["shade"])
    table_bytes = sum(t.numel() * t.element_size() for t in tables)
    assert work["bytes"] == table_bytes + 12 * n_px
    assert work["bytes_save_aux"] == work["bytes"] + 12 * n_px * (kw["bounces"] + 1)
    # no hit, no shading: the same frame with every slot -1 costs the floor
    miss = (aux[0] * 0, aux[1] * 0 - 1, aux[2] * 0)
    assert bounds.fwd_work(tables, kw, miss)["ops"] == pytest.approx(
        floor + n_obj * c["eye_coeffs"] + n_px * c["powers"])


def test_bwd_work_scales_with_pixels_lights_and_stages():
    """The backward's count follows the aux: a frame that misses everywhere
    pays only its background rows; occluding every light removes the
    lights' terms and their reverse; a chain whose bounce stages all miss
    costs less than the one the forward saw; the bytes are the tables, the
    gradient rows, the cotangent and the aux per stage."""
    tables, kw, aux = _frame("dingdong")
    n_px, n_obj, n_lights = 32 * 24, tables[0].shape[0], tables[4].shape[0]
    c = bounds.bwd_components()
    work = bounds.bwd_work(tables, kw, aux)
    miss = (aux[0] * 0, aux[1] * 0 - 1, aux[2] * 0)
    assert bounds.bwd_work(tables, kw, miss)["ops"] == 3 * n_px
    n_hit = int((aux[1][0] >= 0).sum())
    assert n_hit > 0
    assert work["ops"] >= n_hit * (c["raygen"] + c["geometry"] + c["normal_root"])
    dark = bounds.bwd_work(tables, kw, (aux[0], aux[1], aux[2] * 0 - 1))["ops"]
    assert n_hit * (c["raygen"] + c["geometry"]) <= dark < work["ops"]
    rows = 18 + 24 * n_obj + 7 * n_lights
    table_floats = n_obj * 24 + 7 * n_lights + 18
    assert work["bytes"] == 4 * (table_floats + rows) + n_px * 24

    tables, kw, aux = _frame("reflection_test")
    assert kw["bounces"] > 0 and (aux[1][1] >= 0).any()
    flat = (aux[0], torch.cat([aux[1][:1], aux[1][1:] * 0 - 1]), aux[2])
    assert bounds.bwd_work(tables, kw, flat)["ops"] < bounds.bwd_work(tables, kw, aux)["ops"]
    assert np.isfinite(bounds.bwd_work(tables, kw, aux)["ops"])


@pytest.mark.parametrize("name", ["dingdong", "20spheres", "reflection_test"])
def test_bwd_work_at_most_the_plain_version(name):
    """render_bwd_plain computes every piece for every pixel and stage
    (masked), so its own count is an upper limit of the path's count."""
    from tpu_ray_tracer_torch.render.bwd_kernel import render_bwd_plain

    tables, kw, aux = _frame(name)
    grad = torch.full((24, 32, 3), 0.5)
    plain = bounds.count_ops(render_bwd_plain, tables[0], tables[2], tables[3], tables[4],
                             tables[7], grad, *aux, width=32, height=24, rows=24,
                             n_lights=tables[4].shape[0], bounces=kw["bounces"])
    assert 0 < bounds.bwd_work(tables, kw, aux)["ops"] <= plain


def test_components_count_each_light_once():
    """A lit light costs its terms once per stage (Phase A keeps them for the
    reverse sweep), and the forward counts its Lambert factor once."""
    c = bounds.bwd_components()
    assert c["terms_directional"] == 6  # n.l (5), the clamp (1)
    assert c["sign_directional"] == 5 and c["sign_spherical"] == 8
    f = bounds.fwd_components(3, 3, 1)
    tables, kw, aux = _frame("cubic")  # every pixel hits, its one light lit
    cls = bounds.stage_classes(tables, kw, aux)
    assert bool(cls["hit"].all()) and bool(cls["lit"].all())
    hit_only = bounds.fwd_work(tables, kw, aux)["ops"]
    no_light = bounds.fwd_work(tables, kw, (aux[0], aux[1], aux[2] * 0 - 1))["ops"]
    lam = f["lambert_spherical"] if float(tables[4][0, 0]) > 0.5 else f["lambert_directional"]
    sign = f["sign_spherical"] if float(tables[4][0, 0]) > 0.5 else f["sign_directional"]
    # all lit -> all occluded: each pixel trades the factor, the sum's terms
    # and every shadow test for the sign and one test of slot 0
    assert hit_only - no_light > 32 * 24 * (lam + f["light_sum"] - sign)


@pytest.mark.parametrize("name", ["clebsch", "dingdong"])
def test_excluding_pair_work_at_32x16(name):
    """Branch B's count (``excluding_pair_work``) at 32x16: every entry its
    expansion, a cubic entry of a cubic class the rest of the plain
    version's solve (four polishes of at least one step among it), the
    other entries nothing more; polish 0 counts as 1; the bound is its
    operations' at the f32 issue rate; the bytes are the inputs' distinct
    elements, the mask, the normal roots taken and the table."""
    from tpu_ray_tracer_torch.ops import camera as camera_ops

    scene = dataclasses.replace(ttt.load_from_file(scene_path(name), device="cpu"),
                                width=32, height=16).astype(torch.float32)
    rot, eye = camera_ops.camera_frame(ttt.Camera.initial(torch.float32, "cpu"))
    dirs = camera_ops.pixel_directions(rot, 32, 16, scene.aspect_ratio, scene.tan_half_fov)
    args = (scene.coefs, eye.expand(dirs.shape), dirs)
    c = bounds.excluding_pair_components(2)
    assert c["expansion"] == bounds.solve_components(2)["expansion"]
    assert c["cubic"] > c["expansion"] + 4 * bounds.solve_components(2)["polish"]
    n_obj = scene.coefs.shape[0]
    n_entries = 32 * 16 * n_obj
    t3 = bounds.ray_poly_coeffs(*args)[0]
    n_cubic = int((t3.abs() > bounds.EPS).sum())
    cubic_class = tuple((scene.coefs[:, :10].abs() > 0).any(1).tolist())
    work = bounds.excluding_pair_work(*args, 2)
    assert 0 < n_cubic < n_entries or name == "clebsch"
    assert work["ops"] == n_entries * c["expansion"] + n_cubic * (c["cubic"] - c["expansion"])
    # the template's classes, or every object cubic-class: spheres have no t^3
    for kinds in (cubic_class, (True,) * n_obj):
        assert bounds.excluding_pair_work(*args, 2, kinds)["ops"] == work["ops"]
    no_cubic = bounds.excluding_pair_work(*args, 2, (False,) * n_obj)
    assert no_cubic["ops"] == n_entries * c["expansion"]
    assert bounds.excluding_pair_work(*args, 0) == bounds.excluding_pair_work(*args, 1)
    ms, by = bounds.bound_ms(work["ops"], work["bytes"], bounds.H100_F32_ISSUE_PER_S)
    assert by == "operations" and ms > 0
    quad = int(((t3.abs() <= bounds.EPS) & (bounds.ray_poly_coeffs(*args)[1].abs()
                                             > bounds.EPS)).sum())
    assert work["bytes"] == (4 * 20 * n_obj + 4 * 3 + 4 * 3 * 32 * 16 + n_obj
                             + 4 * (n_entries - n_cubic - quad + n_entries))
