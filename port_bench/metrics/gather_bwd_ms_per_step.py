"""Device milliseconds a fit step of the traced slice spends in the backward
of the pipeline's per-ray gathers of per-object tables (``scene.coefs[idx]``
and the like): aten's ``indexing_backward_kernel`` where autograd takes the
gather back, or the program's ``select_rows_`` kernels where it has them, so
that the same work reads alike whichever code does it. The matching
operations' durations, summed over the slice, over its units (a step has one
call a row block). None where the slice ran the kernel route (K1 in the
trace)."""

import re

K1 = re.compile(r"render_fwd_kernel")
GATHER_BWD = re.compile(r"indexing_backward_kernel|select_rows_")


def read(trace):
    if not trace.units or any(K1.search(op.name) for op in trace.device_ops):
        return None
    return 1e-3 * sum(op.dur_us for op in trace.device_ops
                      if GATHER_BWD.search(op.name)) / trace.units
