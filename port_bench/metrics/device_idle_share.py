"""The device's idle share of the traced slice, in %: 100 (1 - busy / window),
busy being the union of the device's operations (kernels, copies, fills)."""


def read(trace):
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
