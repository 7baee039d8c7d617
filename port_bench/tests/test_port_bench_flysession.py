"""The view traffic's generator: deterministic for a seed, inside its bounds."""

import json
from pathlib import Path

import numpy as np
import pytest

from port_bench import flysession

ROOT = Path(__file__).resolve().parents[2]
MIX = json.loads((ROOT / "port_bench" / "mixes" / "view.json").read_text())
# the configurations that a view cell can fly through: those with bounds
CONFIGS = sorted(p for p in (ROOT / "port_bench" / "configs").glob("*.json")
                 if "view" in json.loads(p.read_text()))


def _view(path):
    return json.loads(path.read_text())["view"]


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 3 * 2**40 + 1, -12])
def test_session_is_the_same_for_a_seed(seed):
    view = _view(CONFIGS[0])
    first, second = flysession.session(MIX, view, seed), flysession.session(MIX, view, seed)
    for a, b in zip(first, second):
        assert np.array_equal(a, b)
    assert first[0].shape == (MIX["session_frames"], 3)


def test_seeds_give_other_sessions():
    view = _view(CONFIGS[0])
    a = flysession.session(MIX, view, 1)
    b = flysession.session(MIX, view, 2)
    c = flysession.session(MIX, view, 1 + 2**32)
    assert not np.array_equal(a[0], b[0]) and not np.array_equal(a[0], c[0])


@pytest.mark.parametrize("config", CONFIGS, ids=lambda p: p.stem)
@pytest.mark.parametrize("seed", [3, 2**31 + 77])
def test_session_stays_inside_its_bounds_and_moves(config, seed):
    view = _view(config)
    pos, yaw, pitch = flysession.session(MIX, view, seed)
    bounds = view["bounds"]
    for k in range(3):
        lo, hi = bounds["position"][k]
        assert lo <= pos[:, k].min() and pos[:, k].max() <= hi
        assert pos[:, k].max() - pos[:, k].min() > 0.25 * (hi - lo)
    for values, (lo, hi) in ((yaw, bounds["yaw_deg"]), (pitch, bounds["pitch_deg"])):
        assert lo <= values.min() and values.max() <= hi
        assert values.max() - values.min() > 0.25 * (hi - lo)


def test_frames_follow_the_reference_controls():
    cam = flysession.FlyCamera()
    cam.move("w", 0.1)  # yaw 90: forward is +z, at 10 units a second
    assert np.allclose(cam.position, [0.0, 0.0, 1.0])
    cam.mouse_move(100.0, 1000.0)  # yaw falls by 10 degrees, pitch clamps at -89
    assert cam.yaw_deg == pytest.approx(80.0) and cam.pitch_deg == -89.0


@pytest.mark.parametrize("value,expected", [(5.0, 5.0), (11.0, 9.0), (-1.5, 1.5), (21.0, 1.0)])
def test_reflect_folds_back_at_the_bounds(value, expected):
    assert flysession._reflect(value, 0.0, 10.0) == pytest.approx(expected)
