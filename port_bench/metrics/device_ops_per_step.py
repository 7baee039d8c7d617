"""Device operations (kernels, copies, fills) a unit of the traced slice: a
fit step's graph and the host's copies and launches around it."""


def read(trace):
    if not trace.units:
        return None
    return len(trace.device_ops) / trace.units
