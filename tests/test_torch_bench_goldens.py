"""The port's goldens tool (``python -m tpu_ray_tracer_torch.make_bench_goldens``)
against the committed ``bench_goldens/``: the cheapest committed scene by
pixel count (reflection_test, 600x450) written by the port's oracle equals
the committed file within tests/test_bench_goldens.py's F16_TOL, in the
same format; ``--out`` is required, so the committed goldens are never
rewritten unasked.
"""

import pathlib

import numpy as np
import pytest

from tpu_ray_tracer_torch import make_bench_goldens

from test_bench_goldens import F16_TOL

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_written_golden_matches_committed(tmp_path, capsys):
    assert make_bench_goldens.main(["--out", str(tmp_path), "reflection_test"]) == 0
    assert "reflection_test.npz: (450, 600, 3)" in capsys.readouterr().out
    written = np.load(tmp_path / "reflection_test.npz")
    committed = np.load(REPO / "bench_goldens" / "reflection_test.npz")
    assert written.files == committed.files == ["image"]
    assert written["image"].dtype == committed["image"].dtype == np.float16
    assert written["image"].shape == committed["image"].shape
    diff = np.abs(written["image"].astype(np.float32) - committed["image"].astype(np.float32))
    assert diff.max() <= F16_TOL


@pytest.mark.parametrize("argv", [["reflection_test"], ["--out", "x", "no_such_scene"]])
def test_rejects_missing_out_and_unknown_scene(argv):
    with pytest.raises(SystemExit) as exc:
        make_bench_goldens.main(argv)
    assert exc.value.code == 2
