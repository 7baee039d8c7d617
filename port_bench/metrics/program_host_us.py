"""Microseconds a unit that the host spends inside the program (its
outermost ``trt.`` spans) not waiting on the device (less ``trt.step.wait``):
``port_bench/program_spans.py``."""

from port_bench.program_spans import host_us as read  # noqa: F401
