"""Numeric constants of the ray-tracing core.

Values match the reference exactly (reference: include/surface_impl.h:16-19);
csrc/render_fwd.cu carries the same values.
"""

import math

EPS = 1e-7            # root/branch threshold (reference: surface_impl.h:16)
TWO_THIRD_PI = math.pi * 2.0 / 3.0  # (reference: surface_impl.h:17)
SHADOW_BIAS = 1e-2    # offset along normal for secondary rays (surface_impl.h:18)
MAX_T = 1e6           # far clip for valid hits (reference: surface_impl.h:19)
NO_OBJECT = -1        # miss sentinel (reference: src/update-cpu.cpp:8)
