"""Write bench parity goldens from the port's f64 NumPy oracle.

    python -m tpu_ray_tracer_torch.make_bench_goldens --out DIR [scene ...]

The counterpart of ``tools/make_bench_goldens.py``: each named bundled scene
(all 8 by default) is rendered at its own resolution by
``render/reference_cpu.render_image_np`` and written to ``DIR/<scene>.npz``
as float16 under the key ``image``, the format of ``bench_goldens/`` that
the bench reads (quantization error <= 2^-11, small against the 2/255
bad-pixel threshold). ``--out`` is required, so a run never rewrites the
committed goldens unasked.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from .models.loader import load_from_file
from .render.reference_cpu import render_image_np

REPO = Path(__file__).resolve().parents[1]
SCENES = ("dingdong", "monkey_saddle", "20spheres", "reflection_test",
          "quadratic", "cayley", "clebsch", "cubic")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, required=True, help="directory for <scene>.npz")
    ap.add_argument("scenes", nargs="*", metavar="scene",
                    help=f"bundled scenes (default all: {' '.join(SCENES)})")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.scenes) - set(SCENES))
    if unknown:
        ap.error(f"unknown scenes {unknown}; choose from {' '.join(SCENES)}")
    args.out.mkdir(parents=True, exist_ok=True)
    for name in args.scenes or SCENES:
        # the oracle is NumPy on the host: the tables are read there
        scene = load_from_file(REPO / "scenes" / f"{name}.yml", device="cpu")
        golden = render_image_np(scene)
        path = args.out / f"{name}.npz"
        np.savez_compressed(path, image=golden.astype(np.float16))
        print(f"{path}: {golden.shape} ({path.stat().st_size / 1e6:.2f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
