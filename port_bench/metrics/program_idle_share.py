"""The share of the traced slice, in %, in which the device runs nothing
while the host is inside the program's outermost ``trt.`` spans: the device
waiting on the program's host path (``port_bench/program_spans.py``)."""

from port_bench.program_spans import idle_share as read  # noqa: F401
