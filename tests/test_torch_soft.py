"""Soft visibility (``tpu_ray_tracer_torch/diff/soft.py``) against the JAX
package's ``diff/soft.py``, and the scenarios of tests/test_soft.py on the
port.

The parity cases feed the same f32 rays (``camera_rays_np`` of the JAX
package) to both packages: the pair discriminant and the pair-excluded root
table on clebsch and on dingdong (a cubic and two spheres), with and without
the template's ``pair_kinds``, and the soft render with its gradient at
32x24, tau 0.15, under tests/test_pallas.py:174-181's rule. The scenarios
keep the JAX tests' scenes, sizes, step budgets and assertions; their
targets come from ``render_image_kernel`` (the plain version of the forward
kernel on the CPU), as the JAX tests' come from the Pallas kernel.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_ray_tracer as trt
import tpu_ray_tracer_torch as ttt
from tpu_ray_tracer.diff import soft as jsoft
from tpu_ray_tracer.render.reference_cpu import camera_rays_np
from tpu_ray_tracer_torch.diff import soft as tsoft
from tpu_ray_tracer_torch.diff.inverse import InverseProblem, make_loss_fn, tau_schedule
from tpu_ray_tracer_torch.models.surface import COEF_INDEX

from conftest import scene_path
from test_torch_grad import assert_group_close, to_torch

CONFIG = ttt.RenderConfig(geom_dtype="float32", polish_iters=2, bounces=0, chunk_px=None)


def camera():
    """The reference pose in f32 on the CPU."""
    return ttt.Camera.initial(torch.float32, "cpu")


def load(name, width=32, height=24):
    return dataclasses.replace(ttt.load_from_file(scene_path(name), device="cpu"),
                               width=width, height=height)


def load_yaml(text):
    return ttt.load_from_string(text, device="cpu")


def target_of(scene):
    """The frame at the reference pose through the forward kernel's route
    (its plain version here), as the JAX tests render theirs."""
    with torch.no_grad():
        return ttt.render_image_kernel(scene, camera(), polish_iters=2, bounces=0)


def f32_rays(jscene):
    o, d = camera_rays_np(jscene)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("name", ["clebsch", "dingdong"])
@pytest.mark.parametrize("with_kinds", [False, True])
def test_pair_coverage_and_excluded_roots_match_jax(name, with_kinds):
    """The normalized pair discriminant within 2e-5 of the JAX package's
    (measured 6.5e-6), and the pair-excluded root table with the same
    validity and t within 1e-4 relative on every (ray, object)."""
    jscene = dataclasses.replace(trt.load_from_file(scene_path(name)), width=32, height=24)
    o, d = f32_rays(jscene)
    coefs = np.asarray(jscene.coefs, np.float32)
    kinds = tuple(bool(x) for x in (np.abs(coefs[:, :10]) > 0).any(1)) if with_kinds else None

    @jax.jit
    def ref_fn(c, o_, d_):
        return (jsoft.pair_coverage(c, o_, d_, pair_kinds=kinds),
                jsoft._roots_excluding_pair(c, o_, d_, 2, pair_kinds=kinds))

    ref_cov, ref_t = (np.asarray(a) for a in ref_fn(*map(jnp.asarray, (coefs, o, d))))
    args = tuple(map(torch.from_numpy, (coefs, o, d)))
    cov = tsoft.pair_coverage(*args, pair_kinds=kinds).numpy()
    t = tsoft._roots_excluding_pair(*args, 2, pair_kinds=kinds).detach().numpy()
    assert cov.shape == ref_cov.shape == t.shape
    assert (cov < 0).any() and (cov > 0).any()
    np.testing.assert_allclose(cov, ref_cov, rtol=0, atol=2e-5)
    v_ref, v = (ref_t >= 1e-7) & (ref_t < 1e6), (t >= 1e-7) & (t < 1e6)
    assert v_ref.any()
    np.testing.assert_array_equal(v, v_ref)
    np.testing.assert_allclose(t[v], ref_t[v], rtol=1e-4)


def test_render_rays_soft_and_gradient_match_jax():
    """clebsch 32x24, tau 0.15: the soft image within 1e-5 of the JAX
    package's (measured 7e-7), and the gradient of sum(w * image) with
    respect to the coefficients, the lights and the rays' origins and
    directions within tests/test_pallas.py:174-181's rule (measured 3e-5
    at worst, the directions)."""
    jscene = dataclasses.replace(trt.load_from_file(scene_path("clebsch")), width=32, height=24)
    o, d = f32_rays(jscene)
    w = np.linspace(0.1, 1.0, 24 * 32 * 3).reshape(24, 32, 3).astype(np.float32)
    s32 = jax.tree.map(jnp.asarray, jscene.astype(jnp.float32))

    def ref_loss(coefs, light_color, light_p, origin, dir):
        s = dataclasses.replace(s32, coefs=coefs, light_color=light_color, light_p=light_p)
        img = jsoft.render_rays_soft(s, origin, dir, polish_iters=2, tau=0.15)
        return jnp.sum(w * img), img

    (_, ref_img), ref_grads = jax.jit(jax.value_and_grad(
        ref_loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(
        s32.coefs, s32.light_color, s32.light_p, jnp.asarray(o), jnp.asarray(d))

    t32 = to_torch(jscene).astype(torch.float32)
    leaves = {"coefs": t32.coefs, "light_color": t32.light_color, "light_p": t32.light_p,
              "origin": torch.from_numpy(o), "dir": torch.from_numpy(d)}
    leaves = {k: v.clone().requires_grad_() for k, v in leaves.items()}
    scene = dataclasses.replace(t32, coefs=leaves["coefs"], light_color=leaves["light_color"],
                                light_p=leaves["light_p"])
    img = tsoft.render_rays_soft(scene, leaves["origin"], leaves["dir"], polish_iters=2,
                                 tau=0.15)
    (torch.from_numpy(w) * img).sum().backward()
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(ref_img), rtol=0, atol=1e-5)
    for (group, leaf), ref in zip(leaves.items(), ref_grads):
        assert np.abs(np.asarray(ref)).max() > 0, group
        assert_group_close(group, leaf.grad.numpy(), np.asarray(ref))


# --- the scenarios of tests/test_soft.py ---

def test_soft_render_converges_to_hard():
    """As tau -> 0 the soft render equals the hard pipeline away from
    pair-event boundaries (tests/test_soft.py:36-59)."""
    for name in ("clebsch", "quadratic"):
        scene = load(name)
        hard = ttt.render_image(scene, None, CONFIG).numpy()
        o, d = (torch.from_numpy(a) for a in f32_rays(scene))
        with torch.no_grad():
            soft = tsoft.render_rays_soft(scene.astype(torch.float32), o, d, polish_iters=2,
                                          tau=1e-4).numpy()
        frac = (np.abs(soft - hard).max(-1) > 2.0 / 255.0).mean()
        assert frac < 0.02, f"{name}: {frac:.4f}"


def test_recover_clebsch_constant_term_by_descent():
    """The BASELINE.json inverse configuration (tests/test_soft.py:62-114):
    the Clebsch constant term, perturbed 1.0 -> 0.8, recovered by Adam on
    the soft loss (tau 0.15), the gradient masked to that entry."""
    scene = load("clebsch")
    tgt = target_of(scene)
    loss_fn = make_loss_fn(InverseProblem(scene_template=scene, config=CONFIG,
                                          param_fields=("coefs",), soft_tau=0.15))
    ci = COEF_INDEX["c"]
    mask = torch.zeros(1, 20)
    mask[0, ci] = 1.0
    coefs = scene.coefs.to(torch.float32).clone()
    coefs[0, ci] = 0.8
    coefs.requires_grad_()
    opt = torch.optim.Adam([coefs], lr=2e-2)
    first_loss = None
    for _ in range(100):
        opt.zero_grad()
        loss = loss_fn({"coefs": coefs}, camera(), tgt)
        loss.backward()
        if first_loss is None:
            first_loss = float(loss.detach())
        coefs.grad.mul_(mask)
        opt.step()
    c_final = float(coefs[0, ci])
    assert np.isfinite(c_final)
    assert abs(c_final - 1.0) < 0.03, f"recovered c = {c_final}"
    assert float(loss.detach()) < first_loss * 0.5


def _exponential_decay(init, transition_steps, rate):
    """optax.exponential_decay (continuous) as a function of the step."""
    return lambda i: init * rate ** (i / transition_steps)


def test_joint_recovery_tau_annealing():
    """Joint recovery of the Clebsch constant and linear terms and all light
    colours with tau continuation 0.2 -> 0.005 and per-group Adam rates
    (Adam param groups for optax.multi_transform; tests/test_soft.py:117-226):
    the soft loss falls >= 4x, the light colours reach 1.5 within 0.1, the
    entries stay bounded and the hard-render error falls >= 3x."""
    scene = load("clebsch")
    tgt = target_of(scene)
    ci = COEF_INDEX
    idx = torch.tensor([ci["c"], ci["x"], ci["y"], ci["z"]])
    rows = torch.zeros_like(idx)
    base = scene.coefs.to(torch.float32)
    entries = torch.tensor([0.8, 9.5, 8.6, 9.4]).requires_grad_()
    lc = (scene.light_color.to(torch.float32) * 0.7).requires_grad_()
    pert = dataclasses.replace(scene, coefs=base.index_put((rows, idx), entries.detach()),
                               light_color=lc.detach().clone())
    loss_fn = make_loss_fn(InverseProblem(scene_template=pert, config=CONFIG,
                                          param_fields=("coefs", "light_color"),
                                          soft_tau=0.2))
    steps = 500
    lr_l = _exponential_decay(3e-2, steps, 0.1)

    def lr_c(i):  # optax.join_schedules of 1e-3, 8e-3 and a decay from 300
        return 1e-3 if i < 100 else 8e-3 if i < 300 else _exponential_decay(8e-3, 200, 0.2)(
            i - 300)

    opt = torch.optim.Adam([{"params": [entries], "lr": lr_c(0)},
                            {"params": [lc], "lr": lr_l(0)}])
    taus = tau_schedule(0.2, 0.005, 250) + [0.005] * (steps - 250)
    first_loss = None
    for i in range(steps):
        opt.param_groups[0]["lr"], opt.param_groups[1]["lr"] = lr_c(i), lr_l(i)
        opt.zero_grad()
        loss = loss_fn({"coefs": base.index_put((rows, idx), entries), "light_color": lc},
                       camera(), tgt, taus[i])
        loss.backward()
        if first_loss is None:
            first_loss = float(loss.detach())
        opt.step()
    final_loss = float(loss.detach())
    assert np.isfinite(final_loss)
    assert final_loss < first_loss / 4.0, (first_loss, final_loss)
    lcr = lc.detach()
    assert abs(float(lcr.mean()) - 1.5) < 0.1, float(lcr.mean())
    rec = entries.detach().numpy()
    assert np.isfinite(rec).all()
    assert np.all(np.abs(rec - np.asarray([1.0, 9.0, 9.0, 9.0])) < 3.0), rec

    rec_scene = dataclasses.replace(scene, coefs=base.index_put((rows, idx), entries.detach()),
                                    light_color=lcr)
    mse0 = float(((target_of(pert) - tgt) ** 2).mean())
    mse1 = float(((target_of(rec_scene) - tgt) ** 2).mean())
    assert mse1 < mse0 / 3.0, (mse0, mse1)


TWO_SPHERE_YAML = """\
width: 32
height: 24
fov: 60
bg_color: [0, 0.1, 0.2]
objects:
  - {type: sphere, center: [-1.2, 0, 4], radius: 1, color: [0.8, 0.8, 0]}
  - {type: sphere, center: [1.2, 0.5, 5], radius: 1.2, color: [0.9, 0.2, 0.2]}
light_sources:
  - {type: directional, intensity: 2, direction: [0.5, -1, 0.3], color: [1, 1, 1]}
"""


def test_multi_object_recovery_without_mask():
    """Both spheres of a two-sphere scene recover their perturbed constant
    terms by joint descent on their degree <= 2 sub-rows, no mask
    (tests/test_soft.py:242-335): soft loss and hard-render error fall >= 5x
    and both radii move toward the truth."""
    scene = load_yaml(TWO_SPHERE_YAML)
    tgt = target_of(scene)
    ci = COEF_INDEX["c"]
    c0 = scene.coefs.to(torch.float32).clone()
    c0[0, ci] += 0.4   # sphere A shrinks (r 1.0 -> 0.72)
    c0[1, ci] -= 0.6   # sphere B grows  (r 1.2 -> 1.45)
    pert = dataclasses.replace(scene, coefs=c0)
    loss_fn = make_loss_fn(InverseProblem(scene_template=pert, config=CONFIG,
                                          param_fields=("coefs",), soft_tau=0.15))

    def radius(cf, i):
        cf = np.asarray(cf, np.float64)
        a = cf[i, 10]
        center = -cf[i, 16:19] / (2 * a)
        return float(np.sqrt(max(float((center ** 2).sum() - cf[i, ci] / a), 0.0)))

    steps = 400
    taus = tau_schedule(0.15, 0.005, 300) + [0.005] * (steps - 300)
    sub = c0[:, 10:].clone().requires_grad_()
    opt = torch.optim.Adam([sub], lr=3e-3)
    first_loss = None
    for i in range(steps):
        opt.zero_grad()
        loss = loss_fn({"coefs": torch.cat([c0[:, :10], sub], 1)}, camera(), tgt, taus[i])
        loss.backward()
        if first_loss is None:
            first_loss = float(loss.detach())
        opt.step()
    cf = torch.cat([c0[:, :10], sub.detach()], 1)
    assert torch.isfinite(cf).all()
    assert float(loss.detach()) < first_loss / 5.0, (first_loss, float(loss.detach()))
    mse0 = float(((target_of(pert) - tgt) ** 2).mean())
    mse1 = float(((target_of(dataclasses.replace(scene, coefs=cf)) - tgt) ** 2).mean())
    assert mse1 < mse0 / 5.0, (mse0, mse1)
    for i, r_true in ((0, 1.0), (1, 1.2)):
        err0 = abs(radius(c0, i) - r_true)
        assert abs(radius(cf, i) - r_true) < 0.75 * err0, (i, radius(c0, i), radius(cf, i))


def test_multi_object_recovery_follows_jax(tmp_path):
    """The first 50 steps of the problem above through the JAX package's
    soft loss (``make_loss_fn`` on the 8-device CPU mesh, ``optax.adam`` at
    lr 3e-3, the same tau schedule) and through the port's, from the same
    start against the same target: at every iterate of the reference's
    descent the port's loss is within 1e-4 relative of the reference's (the
    fit's rule against the JAX package) and its gradient within
    tests/test_pallas.py:174-181's rule.

    The port is held at the reference's iterates, not on a descent of its
    own: the two free descents stay within 5e-5 relative for 31 steps, then
    at step 32 their iterates, at most 7.2e-7 apart (under one f32 ulp of the
    largest entry, 24.67), sit on either side of a jump of the loss by 6.2%,
    and each package, evaluated at the other's iterate, gives the other's
    loss (measured on one CPU; where the jump falls depends on the CPU's
    rounding). So where the 400-step descent ends is the problem's
    conditioning, in both packages (ROADMAP Queue 3)."""
    import optax

    from tpu_ray_tracer.diff import inverse as jinv
    from tpu_ray_tracer.parallel.sharding import make_mesh
    from tpu_ray_tracer.render.pipeline import RenderConfig as JaxRenderConfig

    steps = 50
    taus = tau_schedule(0.15, 0.005, 300)[:steps]
    scene = load_yaml(TWO_SPHERE_YAML)
    tgt = target_of(scene)
    ci = COEF_INDEX["c"]
    c0 = scene.coefs.to(torch.float32).clone()
    c0[0, ci] += 0.4
    c0[1, ci] -= 0.6
    loss_fn = make_loss_fn(InverseProblem(scene_template=dataclasses.replace(scene, coefs=c0),
                                          config=CONFIG, param_fields=("coefs",),
                                          soft_tau=0.15))

    scene_file = tmp_path / "two_spheres.yml"
    scene_file.write_text(TWO_SPHERE_YAML)
    mesh = make_mesh()
    base = jnp.asarray(c0.numpy())
    jloss_fn = jinv.make_loss_fn(jinv.InverseProblem(
        scene_template=dataclasses.replace(trt.load_from_file(str(scene_file)),
                                           coefs=c0.numpy()),
        config=JaxRenderConfig(geom_dtype="float32", polish_iters=2, bounces=0,
                               chunk_px=None),
        param_fields=("coefs",), soft_tau=0.15), mesh)
    jtgt = jinv.pad_target(jnp.asarray(tgt.numpy()), mesh, scene.height)
    jcam = trt.Camera(position=jnp.zeros(3, jnp.float32),
                      yaw_deg=jnp.asarray(90.0, jnp.float32),
                      pitch_deg=jnp.asarray(0.0, jnp.float32))
    vg = jax.jit(jax.value_and_grad(
        lambda s, tau: jloss_fn({"coefs": base.at[:, 10:].set(s)}, jcam, jtgt, tau)))
    sub = base[:, 10:]
    opt = optax.adam(3e-3)
    state = opt.init(sub)
    worst = 0.0
    for i in range(steps):
        ref_loss, ref_grad = vg(sub, taus[i])
        port_sub = torch.from_numpy(np.array(sub)).requires_grad_()
        loss = loss_fn({"coefs": torch.cat([c0[:, :10], port_sub], 1)}, camera(), tgt, taus[i])
        loss.backward()
        rel = abs(float(loss.detach()) - float(ref_loss)) / abs(float(ref_loss))
        worst = max(worst, rel)
        assert rel < 1e-4, (i, float(loss.detach()), float(ref_loss))
        assert_group_close(f"coefs at step {i}", port_sub.grad.numpy(), np.asarray(ref_grad))
        updates, state = opt.update(ref_grad, state)
        sub = optax.apply_updates(sub, updates)
    assert float(ref_loss) < 0.5 * float(vg(base[:, 10:], taus[0])[0]), "no descent"


def test_clebsch_entry_nonidentifiability():
    """The image Jacobian with respect to the 20 Clebsch coefficients is
    rank-deficient from the BASELINE view (tests/test_soft.py:338-372): at
    most 14 and at least 6 singular values above 1e-3 of the largest. The
    20 columns are Jacobian-vector products of the pipeline's render."""
    scene = load("clebsch").astype(torch.float32)

    def img_of(coefs):
        return ttt.render_image(dataclasses.replace(scene, coefs=coefs), camera(),
                                CONFIG).reshape(-1)

    cols = []
    for m in range(20):
        v = torch.zeros_like(scene.coefs)
        v[0, m] = 1.0
        cols.append(torch.autograd.functional.jvp(img_of, scene.coefs, v)[1])
    jac = torch.stack(cols, 1).numpy()
    assert np.isfinite(jac).all()
    s = np.linalg.svd(jac, compute_uv=False)
    observable = int((s >= 1e-3 * s[0]).sum())
    assert observable <= 14, f"rank jumped to {observable}"
    assert observable >= 6


POKING_SPHERE_YAML = """\
width: 40
height: 30
fov: 60
bg_color: [0, 0.1, 0.2]
objects:
  - {type: sphere, center: [0, 0, 5], radius: 1.5, color: [0.9, 0.8, 0.1]}
  - {type: sphere, center: [0.3, 0.1, 3.6], radius: 0.55, color: [0.9, 0.15, 0.1]}
light_sources:
  - {type: directional, intensity: 2, direction: [0.4, -1, 0.5], color: [1, 1, 1]}
"""


def test_cross_object_ordering_boundary_descends_hard():
    """The t-ordering boundary of a sphere poking through another does not
    stall hard descent (tests/test_soft.py:388-455): the gradient's sign is
    right on both sides of the truth, central differences agree with the
    gradient, and 150 Adam steps recover the constant term to 1e-2."""
    scene = load_yaml(POKING_SPHERE_YAML)
    tgt = target_of(scene)
    ci = COEF_INDEX["c"]
    base = scene.coefs.to(torch.float32)
    ctrue = float(base[1, ci])
    loss_fn = make_loss_fn(InverseProblem(scene_template=scene, config=CONFIG,
                                          param_fields=("coefs",)))
    pos = (torch.tensor([1]), torch.tensor([ci]))

    def f(c_b):
        return loss_fn({"coefs": base.index_put(pos, c_b.reshape(1))}, camera(), tgt)

    def g(value):
        c_b = torch.tensor(value, dtype=torch.float32, requires_grad=True)
        f(c_b).backward()
        return float(c_b.grad)

    assert g(ctrue + 0.2) > 0
    assert g(ctrue - 0.2) < 0
    h = 2e-3
    with torch.no_grad():
        fd = (float(f(torch.tensor(ctrue + 0.25 + h))) -
              float(f(torch.tensor(ctrue + 0.25 - h)))) / (2 * h)
    ad = g(ctrue + 0.25)
    assert abs(fd - ad) < 0.3 * abs(fd) + 1e-5, (fd, ad)

    x = torch.tensor(ctrue + 0.25, requires_grad=True)
    opt = torch.optim.Adam([x], lr=5e-3)
    for _ in range(150):
        opt.zero_grad()
        f(x).backward()
        opt.step()
    assert abs(float(x) - ctrue) < 1e-2, float(x) - ctrue
