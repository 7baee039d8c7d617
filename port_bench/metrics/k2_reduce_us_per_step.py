"""Device microseconds a fit step of the traced slice spends in K2's
cross-block sum of its gradient rows (``reduce_rows_kernel`` of
``csrc/render_bwd.cu``): the matching operations' durations, summed over
the slice, over its units. None where the slice ran no such kernel."""

import re

REDUCE = re.compile(r"reduce_rows_kernel")


def read(trace):
    ops = [op for op in trace.device_ops if REDUCE.search(op.name)]
    if not trace.units or not ops:
        return None
    return sum(op.dur_us for op in ops) / trace.units
