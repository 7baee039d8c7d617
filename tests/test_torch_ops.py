"""The port's pipeline ops (``ops/poly.py``, ``ops/roots.py``,
``ops/intersect.py``, ``ops/shading.py``) against the JAX package's, on
inputs made with numpy from a seed.

Limits: f64 results equal the JAX functions' to 1e-12 and f32 results to
1e-5 of their scale (the sum of the magnitudes that enter each value, so
that summation order, the only difference, is what the limit bounds); the
root solve as in tests/test_roots.py; the IFT backward against finite
differences by ``torch.autograd.gradcheck`` in f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ray_tracer.ops import intersect as jintersect
from tpu_ray_tracer.ops import poly as jpoly
from tpu_ray_tracer.ops import roots as jroots
from tpu_ray_tracer.ops import shading as jshading
from tpu_ray_tracer_torch.models import surface as tsurface
from tpu_ray_tracer_torch.ops import intersect as tintersect
from tpu_ray_tracer_torch.ops import poly as tpoly
from tpu_ray_tracer_torch.ops import roots as troots
from tpu_ray_tracer_torch.ops import shading as tshading
from tpu_ray_tracer_torch.ops.constants import EPS

from test_roots import _random_cases, _run_cases, reference_semantics_oracle

SEED = 20261016
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _objects():
    """A sphere, a plane, the ding-dong cubic, the Cayley cubic and two
    random cubics: [6, 20] f64."""
    rng = np.random.default_rng(SEED)
    return np.stack([
        tsurface.sphere((0.5, -0.2, 6.0), 1.5),
        tsurface.plane((0.0, -2.0, 0.0), (0.1, 1.0, 0.0)),
        tsurface.ding_dong((0.0, 0.0, 8.0)),
        tsurface.cayley(),
        rng.normal(size=20),
        rng.normal(size=20) * 0.1,
    ])


def _rays(n=256, seed=SEED):
    rng = np.random.default_rng(seed)
    origin = rng.uniform(-1.0, 1.0, (n, 3))
    d = rng.normal(size=(n, 3)) * [0.4, 0.4, 1.0] + [0.0, 0.0, 2.0]
    return origin, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(fn):
    return lambda *args: [np.asarray(v) for v in
                          jax.tree.leaves(jax.jit(fn)(*map(jnp.asarray, args)))]


def _close(got, ref, scale, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    err = np.abs(got - ref) / np.maximum(scale, 1e-300)
    assert err.max() <= tol, err.max()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ray_poly_coeffs_matches_jax(dtype):
    coefs, (origin, d) = _objects().astype(dtype), (a.astype(dtype) for a in _rays())
    ref = _j(jpoly.ray_poly_coeffs)(coefs, origin, d)
    got = tpoly.ray_poly_coeffs(_t(coefs), _t(origin), _t(d))
    basis = jpoly.ray_basis(jnp.asarray(origin, jnp.float64), jnp.asarray(d, jnp.float64))
    for k, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == getattr(torch, np.dtype(dtype).name)
        scale = np.abs(np.asarray(basis[k])) @ np.abs(coefs.astype(np.float64)).T
        _close(g.numpy(), r, scale, TOL[dtype])
    for g, r in zip(tpoly.ray_basis(_t(origin), _t(d)), _j(jpoly.ray_basis)(origin, d)):
        _close(g.numpy(), r, np.abs(r).max(), TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_poly_evaluation_matches_jax(dtype):
    """poly_gradient, normal_vector, eval_poly, eval_poly_magnitude and
    monomial_basis at points [R, N, 3] against coefficients [N, 20], and
    at points [R, 3] against per-ray gathered coefficients [R, 20]."""
    rng = np.random.default_rng(SEED + 1)
    coefs = _objects().astype(dtype)
    point = rng.uniform(-3.0, 3.0, (64, coefs.shape[0], 3)).astype(dtype)
    gathered = coefs[rng.integers(0, coefs.shape[0], 64)]
    for c, p in ((coefs, point), (gathered, point[:, 0])):
        mag = _j(jpoly.eval_poly_magnitude)(c, p)[0]
        _close(tpoly.eval_poly_magnitude(_t(c), _t(p)).numpy(), mag, mag, TOL[dtype])
        _close(tpoly.eval_poly(_t(c), _t(p)).numpy(), _j(jpoly.eval_poly)(c, p)[0], mag,
               TOL[dtype])
        grad = _j(jpoly.poly_gradient)(c, p)[0]
        gscale = np.abs(grad).max(-1, keepdims=True) + mag[..., None]
        _close(tpoly.poly_gradient(_t(c), _t(p)).numpy(), grad, gscale, TOL[dtype])
        normal = _j(jpoly.normal_vector)(c, p)[0]
        rel = gscale / np.linalg.norm(grad, axis=-1, keepdims=True)
        _close(tpoly.normal_vector(_t(c), _t(p)).numpy(), normal, rel, 4 * TOL[dtype])
    basis = _j(jpoly.monomial_basis)(point)[0]
    _close(tpoly.monomial_basis(_t(point)).numpy(), basis, np.abs(basis), TOL[dtype])


def test_contraction_is_not_a_matmul():
    """The contraction is products and sums in the inputs' dtype: with the
    reduced-precision matmul setting on it gives the same bits (the card's
    TF32 switch is tests/test_torch_gpu.py's)."""
    coefs, (origin, d) = _objects().astype(np.float32), (a.astype(np.float32) for a in _rays())
    before = tpoly.ray_poly_coeffs(_t(coefs), _t(origin), _t(d))
    prec = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        after = tpoly.ray_poly_coeffs(_t(coefs), _t(origin), _t(d))
    finally:
        torch.set_float32_matmul_precision(prec)
    for a, b in zip(before, after):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cbrt_matches_numpy(dtype):
    """Within 2 ulp of np.cbrt in f32 and 1 ulp in f64 (measured: f32 at
    most 2, on 0.35% of the values over 1 ulp; f64 at most 1), signed, over
    the whole finite range including subnormals; 0, -0, +-inf and NaN as
    np.cbrt gives them."""
    rng = np.random.default_rng(SEED)
    fin = np.finfo(dtype)
    lo = -44.0 if dtype == np.float32 else -320.0
    x = np.sign(rng.normal(size=100000)) * 10.0 ** rng.uniform(lo, np.log10(fin.max), 100000)
    x = np.concatenate([x, [0.0, -0.0, 1.0, -8.0, 27.0, fin.max, -fin.max, fin.tiny]]).astype(dtype)
    got, ref = troots.cbrt(_t(x)).numpy(), np.cbrt(x)
    ulp = np.abs(got.astype(np.float64) - ref) / np.spacing(np.abs(ref)).astype(np.float64)
    assert ulp.max() <= (2.0 if dtype == np.float32 else 1.0), ulp.max()
    assert (np.signbit(got) == np.signbit(ref)).all()
    special = np.asarray([np.inf, -np.inf, np.nan], dtype)
    np.testing.assert_array_equal(troots.cbrt(_t(special)).numpy(), np.cbrt(special))


@pytest.mark.parametrize("kind", ["cubic", "quad", "linear"])
def test_solver_matches_oracle_and_jax(rng, kind):
    """The unpolished f64 solver against the numpy.roots oracle of
    tests/test_roots.py, and equal to the jitted JAX solver to 1e-12."""
    cases = _random_cases(rng, 200, kind)

    def port(t3, t2, t1, t0):
        return troots.min_positive_root(*map(_t, (t3, t2, t1, t0))).numpy()

    _run_cases(cases, port)
    coeffs = [np.asarray([c[i] for c in cases], np.float64) for i in range(4)]
    ref = np.asarray(jax.jit(jroots.min_positive_root)(*map(jnp.asarray, coeffs)))
    np.testing.assert_allclose(port(*coeffs), ref, rtol=1e-12, atol=1e-12)


HAND_CASES = [
    ((1.0, -6.0, 11.0, -6.0), 1.0),    # (t-1)(t-2)(t-3): the smallest
    ((1.0, 0.0, 0.0, 1.0), -1.0),      # t^3 + 1: Cardano's -1, unconditionally
    ((1.0, -5.0, 2.0, 8.0), 2.0),      # (t+1)(t-2)(t-4): 2 replaces the start 4
    ((1.0, 7.0, 14.0, 8.0), -1.0),     # (t+1)(t+2)(t+4): keeps the largest, -1
    ((0.0, 1.0, -2.0, -3.0), 3.0),     # (t+1)(t-3): smaller root < EPS -> larger
    ((0.0, 1.0, 0.0, 1.0), -1.0),      # no real root
    ((0.0, 0.0, 0.0, 5.0), -1.0),      # degenerate
]


@pytest.mark.parametrize("case,want", HAND_CASES)
def test_solver_hand_cases(case, want):
    """tests/test_roots.py:101-154 in f64, each also against the oracle."""
    got = troots.min_positive_root(*(torch.tensor([c], dtype=torch.float64) for c in case))
    assert float(got[0]) == pytest.approx(want, rel=1e-10)
    assert reference_semantics_oracle(*case) == pytest.approx(want, rel=1e-10)


def test_sphere_intersection_end_to_end():
    """Unit sphere at z=5, ray from the origin along +z: entry at t=4
    (tests/test_roots.py:157-166), unpolished f64 and polished f32."""
    coefs = torch.from_numpy(tsurface.sphere((0.0, 0.0, 5.0), 1.0)[None, :])
    o, d = torch.zeros(1, 3, dtype=torch.float64), torch.tensor([[0.0, 0.0, 1.0]],
                                                                 dtype=torch.float64)
    assert float(tintersect.intersect_all(coefs, o, d, 0)[0, 0]) == pytest.approx(4.0, rel=1e-12)
    t32 = tintersect.intersect_all(coefs.float(), o.float(), d.float(), 3)
    assert float(t32[0, 0]) == pytest.approx(4.0, rel=1e-6)


def test_polished_f32_intersect_matches_jax():
    """intersect_all in f32 with 3 polish steps against the jitted JAX
    function on 4096 rays x 6 objects: the same validity and t within 1e-4
    relative on at least 99.9% of the pairs."""
    coefs = _objects().astype(np.float32)
    origin, d = (a.astype(np.float32) for a in _rays(4096, SEED + 2))
    ref = np.asarray(jax.jit(jintersect.intersect_all, static_argnums=3)(
        jnp.asarray(coefs), jnp.asarray(origin), jnp.asarray(d), 3))
    got = tintersect.intersect_all(_t(coefs), _t(origin), _t(d), 3).numpy()
    v_ref, v_got = (ref >= EPS) & (ref < 1e6), (got >= EPS) & (got < 1e6)
    same = (v_ref == v_got) & (~v_ref | (np.abs(got - ref) <= 1e-4 * np.abs(ref)))
    assert v_ref.mean() > 0.2  # the rays hit
    assert same.mean() >= 0.999, same.mean()


def test_ift_backward_matches_finite_differences():
    """gradcheck of the masked hit distance where(valid, t, 0) in f64 with
    respect to the origins, the directions and the coefficients that keep
    each object's degree (tests/test_grads.py:23-82's sphere, ding-dong and
    rays, |dir_y| kept away from 0 so t3 stays away from EPS and validity
    is constant). A cubic coefficient of the sphere is left out: a step of
    1e-6 leaves |t3| below EPS, where the reference's selection ignores t3,
    so finite differences read 0 there while the implicit function theorem
    differentiates the zero set."""
    coefs = torch.from_numpy(np.stack([tsurface.sphere((0.0, 0.0, 5.0), 1.5),
                                       tsurface.ding_dong((0.0, 0.0, 8.0))]))
    dirs = np.asarray([[0.0, 0.3, 1.0], [0.05, 0.25, 1.0], [-0.08, -0.3, 1.0],
                       [0.02, -0.35, 1.0]])
    dirs = torch.from_numpy(dirs / np.linalg.norm(dirs, axis=-1, keepdims=True))
    origins = torch.zeros(4, 3, dtype=torch.float64)
    valid = tintersect.valid_hit_mask(tintersect.intersect_all(coefs, origins, dirs, 0))
    assert valid[:, 0].sum() >= 2 and valid[:, 1].sum() >= 2

    def masked_t(sphere_low, ding_dong, o, d):
        c = torch.stack([torch.cat([coefs[0, :10], sphere_low]), ding_dong])
        t = tintersect.intersect_all(c, o, d, 0)
        return torch.where(valid, t, torch.zeros_like(t))

    inputs = tuple(x.clone().requires_grad_() for x in (coefs[0, 10:], coefs[1], origins, dirs))
    assert torch.autograd.gradcheck(masked_t, inputs, eps=1e-6, atol=1e-6, rtol=1e-3)


@pytest.mark.parametrize("geom", [np.float64, np.float32])
def test_shading_matches_jax(geom):
    """shadow_ray_dirs (with its f32 round trip), surface_color and
    reflect_ray against the JAX functions on random points, normals and a
    mix of both light kinds."""
    rng = np.random.default_rng(SEED + 3)
    light_p = rng.normal(size=(5, 3)).astype(geom) * 4
    sph = np.asarray([True, False, True, False, False])
    light_color = rng.uniform(0, 2, (5, 3)).astype(np.float32)
    point = rng.normal(size=(128, 3)).astype(geom)
    normal = rng.normal(size=(128, 3)).astype(geom)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    obj_color = rng.uniform(0, 1, (128, 3)).astype(np.float32)

    ref_sdir, ref_max = _j(jshading.shadow_ray_dirs)(light_p, sph, point)
    sdir, max_t = tshading.shadow_ray_dirs(_t(light_p), _t(sph), _t(point))
    np.testing.assert_array_equal(sdir.numpy(), ref_sdir)
    np.testing.assert_array_equal(max_t.numpy(), ref_max)
    assert sdir.dtype == getattr(torch, np.dtype(geom).name)

    ref = _j(jshading.surface_color)(light_p, sph, light_color, point, normal, obj_color)[0]
    got = tshading.surface_color(_t(light_p), _t(sph), _t(light_color), _t(point), _t(normal),
                                 _t(obj_color))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)

    d = rng.normal(size=(128, 3)).astype(geom)
    np.testing.assert_allclose(tshading.reflect_ray(_t(d), _t(normal)).numpy(),
                               _j(jshading.reflect_ray)(d, normal)[0],
                               rtol=0, atol=4 * TOL[geom])
