"""Row sharding of the port (``tpu_ray_tracer_torch/parallel/sharding.py`` and
the row-sharded loss of ``diff/inverse.py``) on the CPU: the semantics of
tests/test_sharding.py against the port, in real gloo ranks.

A module fixture spawns the ranks once per world size (2 and 4) through
tests/torch_rank_worker.py, which imports no JAX; this process compares
what they return with the port's unsharded renders and gradients and with
the JAX package's sharded ones on the 8-device CPU mesh of
tests/conftest.py. Sizes are test_sharding.py's, but for the kernel route,
which is compared bit for bit at width 64: the kernel's plain version is
bit-stable across row blocks only at a multiple of the SIMD stride.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_ray_tracer as trt
import tpu_ray_tracer_torch as ttt
from tpu_ray_tracer.diff import inverse as jinv
from tpu_ray_tracer.parallel import sharding as jsharding
from tpu_ray_tracer.render.pipeline import RenderConfig as JaxRenderConfig
from tpu_ray_tracer_torch.diff import inverse
from tpu_ray_tracer_torch.parallel import sharding
from tpu_ray_tracer_torch.parity import bad_pixel_fraction
from tpu_ray_tracer_torch.render.kernel_backend import render_rows_kernel

from conftest import scene_path
from test_torch_grad import assert_group_close
from torch_rank_worker import CONFIG, spawn

JAX_CONFIG = JaxRenderConfig(geom_dtype="float32", polish_iters=2, bounces=0, chunk_px=None)


def load(name, width, height):
    return dataclasses.replace(ttt.load_from_file(scene_path(name), device="cpu"),
                               width=width, height=height)


def jax_load(name, width, height):
    return dataclasses.replace(trt.load_from_file(scene_path(name)), width=width, height=height)


def pose():
    return ttt.Camera.initial(torch.float32, "cpu")


def jax_pose():
    return trt.Camera(position=jnp.zeros(3, jnp.float32), yaw_deg=jnp.asarray(90.0, jnp.float32),
                      pitch_deg=jnp.asarray(0.0, jnp.float32))


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request, tmp_path_factory):
    return spawn("sharding", request.param, tmp_path_factory.mktemp(f"sharding{request.param}"))


def test_every_rank_returns_the_same(ranks):
    """The gathered frames, the all-reduced losses and gradients, the train
    steps' losses and parameters, and the slot order each rank's statics
    memo derives from them are the same on every rank, bit for bit."""
    assert [int(r["rank"]) for r in ranks] == list(range(len(ranks)))
    for r in ranks[1:]:
        for key in ranks[0]:
            if key not in ("rank", "shard_rows", "short/torch/span", "short/kernel/span"):
                np.testing.assert_array_equal(r[key], ranks[0][key], err_msg=key)


@pytest.mark.parametrize("size", [(32, 24), (16, 21)], ids=["32x24", "16x21-padded"])
def test_torch_route_matches_unsharded_and_jax(ranks, size):
    """quadratic through the pipeline: atol 1e-6 against the port's
    unsharded frame, and against JAX's ``render_image_sharded(backend="xla")``
    under tests/test_torch_pipeline.py's bad-pixel limit (0.005)."""
    got = ranks[0][f"torch_{size[0]}x{size[1]}"]
    with torch.no_grad():
        single = ttt.render_image(load("quadratic", *size), pose(), CONFIG).numpy()
    assert got.shape == single.shape == (size[1], size[0], 3)
    np.testing.assert_allclose(got, single, atol=1e-6)
    xla = np.asarray(jsharding.render_image_sharded(
        jax_load("quadratic", *size), jax_pose(), jsharding.make_mesh(), JAX_CONFIG,
        backend="xla"))
    assert bad_pixel_fraction(got, xla) < 0.005


@pytest.mark.parametrize("size", [(64, 24), (64, 21)], ids=["64x24", "64x21-padded"])
def test_kernel_route_equals_unsharded_bitwise(ranks, size):
    """dingdong (cubic and quadrics, both light kinds) through the forward
    kernel's route: the gathered frame equals ``render_image_kernel``'s."""
    with torch.no_grad():
        single = ttt.render_image_kernel(load("dingdong", *size), pose(), polish_iters=3,
                                         bounces=0).numpy()
    np.testing.assert_array_equal(ranks[0][f"kernel_{size[0]}x{size[1]}"], single)


@pytest.fixture(scope="module")
def jax_loss_and_grad():
    """JAX ``make_loss_fn(problem, mesh)`` on the XLA backend: loss and
    light-colour gradient on cayley 24x16 (light colours x0.6) against the
    port's unsharded frame of the unperturbed scene (which the ranks' target
    equals within 1e-6), test_sharding.py's train-step case."""
    with torch.no_grad():
        frame = ttt.render_image(load("cayley", 24, 16), pose(), CONFIG).numpy()
    scene = jax_load("cayley", 24, 16)
    perturbed = dataclasses.replace(scene, light_color=np.asarray(scene.light_color) * 0.6)
    mesh = jsharding.make_mesh()
    problem = jinv.InverseProblem(scene_template=perturbed, config=JAX_CONFIG,
                                  param_fields=("light_color",), backend="xla")
    params = jinv.extract_params(perturbed.astype(jnp.float32), ("light_color",))
    target = jinv.pad_target(jnp.asarray(frame), mesh, scene.height)
    loss, grads = jax.jit(jax.value_and_grad(jinv.make_loss_fn(problem, mesh)))(
        params, jax_pose(), target)
    return float(loss), np.asarray(grads["light_color"])


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_sharded_loss_and_grads_match_jax(ranks, jax_loss_and_grad, backend):
    """The all-reduced loss within 1e-4 relative and the gradient within
    relerr 1e-4 of JAX's (test_sharding.py:196-200's rule), on both routes;
    and equal to the port's unsharded loss and gradient to f32 rounding."""
    loss, grad = float(ranks[0][f"{backend}/loss"]), ranks[0][f"{backend}/grad/light_color"]
    assert bool(ranks[0][f"{backend}/whole_frame_raises"])  # a rank holds no whole frame
    jloss, jgrad = jax_loss_and_grad
    assert loss == pytest.approx(jloss, rel=1e-4)
    assert np.abs(grad - jgrad).max() / max(np.abs(jgrad).max(), 1e-9) < 1e-4
    assert np.abs(grad).max() > 0
    scene = load("cayley", 24, 16)
    perturbed = dataclasses.replace(scene, light_color=scene.light_color * 0.6)
    problem = inverse.InverseProblem(perturbed, CONFIG, ("light_color",), backend=backend)
    params = inverse.extract_params(perturbed.astype(torch.float32), ("light_color",))
    single = inverse.make_loss_fn(problem).backward(params, pose(),
                                                    torch.as_tensor(ranks[0]["cayley_target"]))
    assert loss == pytest.approx(float(single), rel=1e-5)
    np.testing.assert_allclose(grad, params["light_color"].grad.numpy(), rtol=1e-5, atol=1e-9)


def test_sharded_descent(ranks):
    """20 sharded Adam steps take the loss below half its first value
    (test_sharding.py:76-125)."""
    losses = ranks[0]["descent"]
    assert np.isfinite(losses).all() and losses[0] > 0
    assert losses[-1] < 0.5 * losses[0], losses


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_short_ranks_give_the_unsharded_gradient(ranks, backend):
    """3 rows: over 4 ranks the last span is empty, over 2 the last is one
    row; on the pipeline route in blocks of one row, so the ranks run
    different numbers of blocks. Nothing deadlocks, and the loss and the
    coefficient, light and camera gradients are the unsharded ones within
    the fused-backward rule."""
    world = len(ranks)
    spans = [tuple(r[f"short/{backend}/span"]) for r in ranks]
    assert sum(n for _, n in spans) == 3 and spans[0][0] == 0
    assert (spans[-1][1] == 0) == (world == 4)
    if backend == "torch":
        assert int(ranks[0]["short/torch/block_rows"]) == 1
    short = dataclasses.replace(load("cayley", 24, 16), height=3)
    short = dataclasses.replace(short, light_color=short.light_color * 0.6)
    with torch.no_grad():
        frame = ttt.render_image(short, pose(), CONFIG).numpy()
    np.testing.assert_allclose(ranks[0]["short_frame"], frame, atol=1e-6)
    fields = ("coefs", "light_color", "camera")
    problem = inverse.InverseProblem(short, CONFIG, fields, backend=backend)
    params = inverse.extract_params(short.astype(torch.float32), fields, camera=pose())
    loss = inverse.make_loss_fn(problem).backward(
        params, pose(), torch.as_tensor(ranks[0]["cayley_target"][:3]))
    assert float(ranks[0][f"short/{backend}/loss"]) == pytest.approx(float(loss), rel=1e-5)
    for key, t in inverse._named_tensors(params):
        assert_group_close(key, ranks[0][f"short/{backend}/grad/{key}"], t.grad.numpy())


def test_dryrun_multichip_counterpart(ranks):
    """``__graft_entry__.dryrun_multichip``: every default field x0.6, one
    train step through the kernels: a finite loss with signal, and the step
    moves the parameters."""
    loss = float(ranks[0]["dryrun/loss"])
    assert np.isfinite(loss) and loss > 1e-8
    assert bool(ranks[0]["dryrun/moved"])


def test_replicate_and_shard_rows(ranks):
    """``replicate`` gives rank 0's tensors everywhere (a bool table too);
    ``shard_rows`` gives each rank its block of a padded tensor, the blocks
    tiling it in rank order."""
    world = len(ranks)
    kinds = load("cayley", 24, 16).light_is_spherical.numpy()
    for r in ranks:
        np.testing.assert_array_equal(r["replicated"], np.zeros((2, 3), np.float32))
        np.testing.assert_array_equal(r["replicated_kinds"], kinds)
    whole = np.arange(sharding.padded_rows(21, world) * 2).reshape(-1, 2)
    np.testing.assert_array_equal(np.concatenate([r["shard_rows"] for r in ranks]), whole)


def test_one_process_needs_no_collective(tmp_path):
    """Without a process group the world is one rank on the device the
    caller names: shard_rows and replicate return their input, and the
    default device is the card (raising without one). Only a group the
    caller passes splits the rows: in an initialized world ``make_mesh``
    takes the world's group, and a loss made without one stays whole."""
    mesh = sharding.make_mesh("cpu")
    assert (mesh.rank, mesh.size, mesh.device, mesh.group) == (0, 1, torch.device("cpu"), None)
    if torch.cuda.is_available():
        assert sharding.make_mesh().device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharding.make_mesh()
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(sharding.shard_rows(x), x)
    assert sharding.replicate(x) is x
    for height, n in ((24, 8), (21, 8), (3, 4), (1, 1), (720, 2)):
        assert sharding.padded_rows(height, n) == jsharding.padded_rows(height, n)
    problem = inverse.InverseProblem(load("cayley", 24, 16), CONFIG, ("light_color",))
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                                         rank=0, world_size=1)
    try:
        assert sharding.make_mesh("cpu").group is torch.distributed.group.WORLD
        loss_fn = inverse.make_loss_fn(problem)
        assert loss_fn.group is None and loss_fn.span == (0, 16)
    finally:
        torch.distributed.destroy_process_group()


def test_render_image_sharded_checks():
    """Unknown backends raise, as in the JAX package; a call that would
    record a gradient raises rather than drop it at the gather; in one
    process the frame is the unsharded one."""
    scene = load("dingdong", 64, 8)
    with pytest.raises(ValueError, match="unknown backend"):
        sharding.render_image_sharded(scene, pose(), CONFIG, backend="xla")
    leaf = dataclasses.replace(scene, light_color=scene.light_color.clone().requires_grad_())
    with pytest.raises(NotImplementedError, match="forward-only"):
        sharding.render_image_sharded(leaf, pose(), CONFIG)
    with torch.no_grad():
        frame = sharding.render_image_sharded(scene, pose(), CONFIG)
        single = ttt.render_image_kernel(scene, pose(), polish_iters=2, bounces=0)
    assert torch.equal(frame, single)


def test_row_blocks_at_row0_sum_to_the_frame_gradient():
    """The backward at row0 > 0 (cam[17], which the fused backward reads):
    the gradients of three row blocks of dingdong 64x24 at pitch 5 (one at
    row 0, two past it) sum to the whole frame's, every scene and camera
    group within the fused-backward rule."""
    scene = load("dingdong", 64, 24)
    fields = ("coefs", "colors", "light_p", "light_color", "bg_color", "tan_half_fov")
    cam_fields = ("position", "yaw_deg", "pitch_deg")
    weights = torch.linspace(0.1, 1.0, 24 * 64 * 3).reshape(24, 64, 3)

    def grads(blocks):
        leaves = {f: getattr(scene, f).detach().clone().requires_grad_() for f in fields}
        cam = ttt.Camera(torch.zeros(3), torch.tensor(90.0), torch.tensor(5.0))
        cam_leaves = {f: getattr(cam, f).clone().requires_grad_() for f in cam_fields}
        s, c = dataclasses.replace(scene, **leaves), ttt.Camera(**cam_leaves)
        for y0, rows in blocks:
            image = render_rows_kernel(s, c, y0, rows, polish_iters=3, bounces=0)
            (weights[y0:y0 + rows] * image).sum().backward()
        return {k: v.grad.numpy() for k, v in {**leaves, **cam_leaves}.items()}

    whole = grads([(0, 24)])
    blocks = grads([(0, 7), (7, 10), (17, 7)])
    for key in whole:
        assert_group_close(key, blocks[key], whole[key])
    assert np.abs(whole["light_color"]).max() > 0 and np.abs(whole["pitch_deg"]).max() > 0


@pytest.mark.slow
def test_weak_scaling_sharded_overhead_bounded(tmp_path):
    """The counterpart of test_sharding.py's wall-clock check: the same
    64x64 frame sharded across 2 gloo ranks costs no more than 3x the
    unsharded render plus 0.1 s (best of 3 each, by the host clock). Slow:
    wall-clock bounds flake on a loaded host."""
    for r in spawn("scaling", 2, tmp_path):
        assert float(r["sharded_s"]) <= 3.0 * float(r["single_s"]) + 0.1, r
