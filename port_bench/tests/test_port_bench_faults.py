"""``correct`` comes out false when the timed path is broken underneath, and
when the control (the plain reference in bfloat16) takes the program's
place: whole runs on the CPU at small sizes, the look for a card skipped,
the cells' own limits."""

import dataclasses
from pathlib import Path

import pytest
import torch

from port_bench import harness, run
from port_bench.drivers.fit import gaps
from port_bench.reference import fit as ref

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 1009
VIEW_SIZE = (64, 36)
FIT_SIZE = {"dingdong.fit": (32, 18), "clebsch.fit_soft": (32, 24)}


def view_cell():
    cell = harness.resolve(ROOT, "dingdong.view")
    cell.size = VIEW_SIZE
    cell.mix = dict(cell.mix, warm_frames=2)
    return cell


def run_view(monkeypatch, broken=None):
    from tpu_ray_tracer_torch.render import kernel_backend

    if broken is not None:
        sound = kernel_backend.render_image_kernel
        monkeypatch.setattr(kernel_backend, "render_image_kernel",
                            lambda scene, camera: broken(sound, scene, camera))
    return run.run_cell(view_cell(), SEED, 0.5, False, torch.device("cpu"))


def first_frame_always():
    """A render that returns its state unchanged: the first frame, always."""
    kept = []

    def render(sound, scene, camera):
        if not kept:
            kept.append(sound(scene, camera))
        return kept[0].clone()
    return render


def half_the_rows():
    """A render that leaves half of the rows out."""
    def render(sound, scene, camera):
        image = sound(scene, camera)
        image[image.shape[0] // 2:] = 0.0
        return image
    return render


def channels_swapped():
    """A render whose answer is altered where it is made."""
    return lambda sound, scene, camera: sound(scene, camera).flip(-1)


def test_view_sound_run_is_correct(monkeypatch):
    out = run_view(monkeypatch)
    assert out["correct"], out["compared"]


@pytest.mark.parametrize("fault", [first_frame_always, half_the_rows, channels_swapped],
                         ids=lambda f: f.__name__)
def test_view_fault_is_not_correct(monkeypatch, fault):
    out = run_view(monkeypatch, fault())
    assert not out["correct"], out["compared"]


def test_view_control_is_not_correct():
    cell = view_cell()
    drv = harness.driver(cell).Driver(cell, SEED, torch.device("cpu"))
    for _ in range(8):
        drv.run_unit(harness.no_span)
    control = cell.setting["control"]
    scene = drv.reference_scene(getattr(torch, control["dtype"]))
    images = [drv.reference_frame(scene, i, control["polish_iters"]) for i, _ in drv.kept]
    assert max(drv.readings(images=images)) > cell.limits["bad_px_share"]


def fit_cell(name):
    cell = harness.resolve(ROOT, name)
    cell.size = FIT_SIZE[name]
    return cell


def run_fit(name):
    return run.run_cell(fit_cell(name), SEED, 0.2, False, torch.device("cpu"))


def state_unchanged(monkeypatch):
    from tpu_ray_tracer_torch.diff import inverse

    sound = inverse.make_train_step

    def make(problem, group=None):
        step = sound(problem, group)

        def call(params, optimizer, camera, target, tau=None):
            before = {k: v.detach().clone() for k, v in params.items()}
            loss = step(params, optimizer, camera, target, tau)
            with torch.no_grad():
                for k, v in params.items():
                    v.copy_(before[k])
            return loss
        return call
    monkeypatch.setattr(inverse, "make_train_step", make)


def half_the_batch(monkeypatch):
    from tpu_ray_tracer_torch.diff import inverse

    sound = inverse.make_loss_fn

    def make(problem, group=None):
        loss = sound(problem, group)
        loss.span = (0, loss.span[1] // 2)
        loss.n_valid //= 2
        return loss
    monkeypatch.setattr(inverse, "make_loss_fn", make)


def loss_altered(monkeypatch):
    from tpu_ray_tracer_torch.diff import inverse

    sound = inverse.make_train_step

    def make(problem, group=None):
        step = sound(problem, group)
        return lambda *args: 1.25 * step(*args)
    monkeypatch.setattr(inverse, "make_train_step", make)


@pytest.mark.parametrize("name", sorted(FIT_SIZE))
def test_fit_sound_run_is_correct(name):
    out = run_fit(name)
    assert out["correct"], out["compared"]


@pytest.mark.parametrize("fault", [state_unchanged, half_the_batch, loss_altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", sorted(FIT_SIZE))
def test_fit_fault_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    out = run_fit(name)
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("name", sorted(FIT_SIZE))
def test_fit_control_is_not_correct(name):
    cell = fit_cell(name)
    drv = harness.driver(cell).Driver(cell, SEED, torch.device("cpu"))
    drv.free()
    got = gaps(drv.follow(reference=cell.setting["control"]), drv.follow())
    assert any(got[k] > cell.limits[k] for k in got), got


def test_the_reference_renders_its_own_scene():
    scene = ref.load_scene(ROOT / "port_bench" / "configs" / "dingdong-1280x720.yml", "cpu",
                           torch.float64)
    scene = dataclasses.replace(scene, width=8, height=4)
    image = ref.render_frame(scene, ref.camera(torch.float64, "cpu"), polish_iters=0)
    assert image.shape == (4, 8, 3) and torch.isfinite(image).all()
