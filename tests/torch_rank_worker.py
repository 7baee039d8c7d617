"""One rank of the port's multi-process tests on the CPU.

Not a test file: tests/test_torch_sharding.py and tests/test_torch_multihost.py
spawn ``world`` of these, each with its own ``RANK``, and read the arrays
each writes. It imports only torch, numpy and the port (no JAX, no
conftest), joins a gloo process group through the port's
``initialize_distributed`` over a ``FileStore`` under the test's temporary
directory (no TCP port, so concurrent test workers cannot collide), runs one
suite of cases and writes ``<suite>_rank<r>.npz`` into the output directory:

    python tests/torch_rank_worker.py <sharding|fit|scaling> <world> <store file> <out dir>

Every collective is bounded by the process group's 60 s timeout, and
``spawn`` (the tests' side) bounds the whole run.
"""

import dataclasses
import datetime
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import tpu_ray_tracer_torch as ttt  # noqa: E402
from tpu_ray_tracer_torch.diff import inverse  # noqa: E402
from tpu_ray_tracer_torch.parallel.multihost import (  # noqa: E402
    global_pixel_mesh, host_local_rows, initialize_distributed,
)
from tpu_ray_tracer_torch.parallel.sharding import (  # noqa: E402
    make_mesh, padded_rows, render_image_sharded, replicate, shard_rows,
)
from tpu_ray_tracer_torch.render import kernel_backend  # noqa: E402

CONFIG = ttt.RenderConfig("float32", polish_iters=2, bounces=0, chunk_px=None)
KERNEL_CONFIG = ttt.RenderConfig("float32", polish_iters=3, bounces=0, chunk_px=None)


def spawn(suite, world, out_dir, timeout=240):
    """Run ``suite`` in ``world`` ranks (gloo, a FileStore in ``out_dir``);
    returns each rank's arrays, rank order. Raises, with the output of every
    rank, when one fails or the run outlasts ``timeout`` seconds."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), suite, str(world),
         os.path.join(out_dir, "store"), str(out_dir)],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": str(world)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = "\n".join(f"--- rank {r} (rc {p.returncode}):\n{o.decode(errors='replace')[-3000:]}"
                     for r, (p, o) in enumerate(zip(procs, outs)))
    if any(p.returncode for p in procs):
        raise RuntimeError(f"{suite}: a rank failed\n{logs}")
    results = []
    for r in range(world):
        with np.load(os.path.join(out_dir, f"{suite}_rank{r}.npz")) as data:
            results.append(dict(data))
    return results


def load(name, width, height):
    scene = ttt.load_from_file(os.path.join(REPO, "scenes", f"{name}.yml"), device="cpu")
    return dataclasses.replace(scene, width=width, height=height)


def pose():
    return ttt.Camera.initial(torch.float32, "cpu")


def loss_and_grads(problem, target, fields, group):
    """The all-reduced loss and gradients at the template's values."""
    loss_fn = inverse.make_loss_fn(problem, group)
    params = inverse.extract_params(problem.scene_template.astype(torch.float32), fields,
                                    camera=pose())
    try:
        loss_fn(params, pose(), target)
    except ValueError:
        whole_frame_raises = True
    else:
        whole_frame_raises = False
    loss = loss_fn.backward(params, pose(), target)
    out = {"loss": loss.numpy(), "whole_frame_raises": np.asarray(whole_frame_raises)}
    for key, t in inverse._named_tensors(params):
        out["grad/" + key] = t.grad.numpy()
    return out


def suite_sharding(world, group):
    out = {}
    # sharded renders on both routes, each padding path included
    for name, backend, config, (w, h) in (
            ("quadratic", "torch", CONFIG, (32, 24)), ("quadratic", "torch", CONFIG, (16, 21)),
            ("dingdong", "kernel", KERNEL_CONFIG, (64, 24)),
            ("dingdong", "kernel", KERNEL_CONFIG, (64, 21))):
        with torch.no_grad():
            out[f"{backend}_{w}x{h}"] = render_image_sharded(load(name, w, h), pose(), config,
                                                             backend=backend, group=group).numpy()
    # the loss and its gradient, both routes (the target from the torch route)
    scene = load("cayley", 24, 16)
    with torch.no_grad():
        target = render_image_sharded(scene, pose(), CONFIG, backend="torch", group=group)
    out["cayley_target"] = target.numpy()
    perturbed = dataclasses.replace(scene, light_color=scene.light_color * 0.6)
    for backend in ("torch", "kernel"):
        problem = inverse.InverseProblem(perturbed, CONFIG, ("light_color",), backend=backend)
        for k, v in loss_and_grads(problem, target, problem.param_fields, group).items():
            out[f"{backend}/{k}"] = v
    # descent: 20 sharded steps on the torch route
    problem = inverse.InverseProblem(perturbed, CONFIG, ("light_color",), learning_rate=5e-2)
    params = inverse.extract_params(perturbed.astype(torch.float32), ("light_color",))
    optimizer = problem.optimizer(params)
    step = inverse.make_train_step(problem, group)
    out["descent"] = np.array([step(params, optimizer, pose(), target) for _ in range(20)])
    # short ranks: 3 rows, so over 4 ranks the last has none; the pipeline
    # route in blocks of one row, so that ranks run different block counts
    short = dataclasses.replace(perturbed, height=3)
    with torch.no_grad():
        out["short_frame"] = render_image_sharded(short, pose(), CONFIG, backend="torch",
                                                  group=group).numpy()
    short_target = target[:3]
    fields = ("coefs", "light_color", "camera")
    block_elements = inverse._BLOCK_ELEMENTS
    inverse._BLOCK_ELEMENTS = short.n_objects * (short.n_lights + 1) * short.width
    try:
        for backend in ("torch", "kernel"):
            problem = inverse.InverseProblem(short, CONFIG, fields, backend=backend)
            loss_fn = inverse.make_loss_fn(problem, group)
            out[f"short/{backend}/block_rows"] = np.asarray(loss_fn.block_rows)
            out[f"short/{backend}/span"] = np.asarray(loss_fn.span)
            for k, v in loss_and_grads(problem, short_target, fields, group).items():
                out[f"short/{backend}/{k}"] = v
    finally:
        inverse._BLOCK_ELEMENTS = block_elements
    # the counterpart of __graft_entry__.dryrun_multichip: every default
    # field x0.6, one train step through the kernels
    small = load("dingdong", 32, world * 4)
    with torch.no_grad():
        small_target = render_image_sharded(small, pose(), CONFIG, backend="kernel", group=group)
    problem = inverse.InverseProblem(small, CONFIG, backend="kernel")
    params = {k: (v * 0.6).detach().requires_grad_()
              for k, v in inverse.extract_params(small.astype(torch.float32)).items()}
    before = {k: v.detach().clone() for k, v in params.items()}
    optimizer = problem.optimizer(params)
    out["dryrun/loss"] = np.asarray(inverse.make_train_step(problem, group)(
        params, optimizer, pose(), small_target))
    out["dryrun/moved"] = np.asarray(any(bool((params[k] != before[k]).any()) for k in params))
    # the statics memo is per rank: each re-derives the slot order from its
    # own (equal) coefficients after the step
    perm, n_cubic, posdef = kernel_backend._statics_for(params["coefs"])
    out["dryrun/coefs"] = params["coefs"].detach().numpy()
    out["dryrun/statics"] = np.asarray([*perm, n_cubic, *posdef])
    # replicate (rank 0's values everywhere, a Scene's bool table included)
    # and shard_rows (this rank's block of a padded tensor)
    rank = torch.distributed.get_rank(group)
    tree = replicate({"x": torch.full((2, 3), float(rank)),
                      "scene": dataclasses.replace(short, light_is_spherical=(
                          short.light_is_spherical ^ bool(rank)))}, group)
    out["replicated"] = tree["x"].numpy()
    out["replicated_kinds"] = tree["scene"].light_is_spherical.numpy()
    out["shard_rows"] = shard_rows(torch.arange(padded_rows(21, world) * 2).reshape(-1, 2),
                                   group).numpy()
    return out


def suite_scaling(group):
    """The same frame, unsharded and sharded across the ranks (torch route,
    quadratic 64x64), each the best of 3 after a warm-up, by the host clock."""
    scene = load("quadratic", 64, 64)

    def best(fn):
        fn()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return min(times)

    with torch.no_grad():
        single = best(lambda: ttt.render_image(scene, pose(), CONFIG))
        sharded = best(lambda: render_image_sharded(scene, pose(), CONFIG, backend="torch",
                                                    group=group))
    return {"single_s": np.asarray(single), "sharded_s": np.asarray(sharded)}


def suite_fit(out_dir, group):
    """A fit with a checkpoint path shared by every rank; only rank 0 may
    write it. quadratic 32x16 with its light colours x0.6, kernel route."""
    scene = load("quadratic", 32, 16)
    with torch.no_grad():
        target = render_image_sharded(scene, pose(), CONFIG, backend="kernel", group=group)
    problem = inverse.InverseProblem(
        dataclasses.replace(scene, light_color=scene.light_color * 0.6), CONFIG,
        ("light_color",), learning_rate=5e-2, backend="kernel")
    ckpt = os.path.join(out_dir, "shared_ckpt.npz")
    writes = []
    save = inverse.save_checkpoint

    def spy(path, params, optimizer, step):
        writes.append(step)
        save(path, params, optimizer, step)

    inverse.save_checkpoint = spy
    try:
        params, losses = inverse.fit(problem, target, pose(), steps=3, log_every=0,
                                     checkpoint_path=ckpt, checkpoint_every=1, group=group)
    finally:
        inverse.save_checkpoint = save
    torch.distributed.barrier()
    with np.load(ckpt) as data:
        ckpt_step = int(data["__step__"])
    return {"losses": np.asarray(losses), "light_color": params["light_color"].detach().numpy(),
            "ckpt_writes": np.asarray(len(writes)), "ckpt_step": np.asarray(ckpt_step),
            "row_span": np.asarray(host_local_rows(scene.height, group)),
            "devices": np.asarray([str(d) for d in global_pixel_mesh("cpu")])}


def main():
    suite, world, store, out_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    initialize_distributed(device="cpu", init_method=f"file://{store}", world_size=world,
                           timeout=datetime.timedelta(seconds=60))
    mesh = make_mesh("cpu")
    assert (mesh.size, mesh.device) == (world, torch.device("cpu")), mesh
    if suite == "sharding":
        out = suite_sharding(world, mesh.group)
    elif suite == "fit":
        out = suite_fit(out_dir, mesh.group)
    else:
        out = suite_scaling(mesh.group)
    out["rank"] = np.asarray(mesh.rank)
    np.savez(os.path.join(out_dir, f"{suite}_rank{mesh.rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
