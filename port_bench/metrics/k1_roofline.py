"""K1's share of its roofline, in %: the least time of its calls (the frozen
count of each call's operations and bytes at the published peaks,
``port_bench/roofline.py``) over their device time, on the traced units
whose count was made. K1 is ``render_fwd_kernel`` of the port's
``csrc/render_fwd.cu``, found in the trace by its name."""

PATTERNS = (r"render_fwd_kernel",)


def read(trace):
    times = trace.per_unit_s(PATTERNS)
    if times is None:
        return None
    least = trace.least_s("k1")
    if not least:
        return None
    return 100.0 * sum(least.values()) / sum(times[u] for u in least)
