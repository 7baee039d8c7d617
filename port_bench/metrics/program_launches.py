"""Kernel launches, asynchronous copies and fills and graph launches a unit
that the host makes inside the program's outermost ``trt.`` spans
(``port_bench/program_spans.py``)."""

from port_bench.program_spans import launches as read  # noqa: F401
