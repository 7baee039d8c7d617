"""K2's share of its roofline, in %: the least time of its calls (the frozen
count of each call's operations and bytes at the published peaks,
``port_bench/roofline.py``) over their device time. K2 is the port's
``csrc/render_bwd.cu``: ``render_bwd_kernel`` and its ``reduce_rows_kernel``,
one launch of each a call, found in the trace by their names."""

PATTERNS = (r"render_bwd_kernel", r"reduce_rows_kernel")


def read(trace):
    times = trace.per_unit_s(PATTERNS)
    if times is None:
        return None
    least = trace.least_s("k2")
    if not least:
        return None
    return 100.0 * sum(least.values()) / sum(times[u] for u in least)
