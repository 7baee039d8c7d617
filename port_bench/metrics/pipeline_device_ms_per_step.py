"""Device milliseconds a fit step of the traced slice (the union of its
operations) on the pipeline route: the pipeline's and soft visibility's
kernels. None where the slice ran the kernel route (K1 in the trace)."""

import re

K1 = re.compile(r"render_fwd_kernel")


def read(trace):
    if not trace.units or any(K1.search(op.name) for op in trace.device_ops):
        return None
    return 1e3 * trace.busy_s / trace.units
