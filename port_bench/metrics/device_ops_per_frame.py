"""Device operations (kernels, copies, fills) a frame of the traced slice:
what the host path and the frame's graph put on the device. A frame is the
view's unit, so this is ``device_ops_per_step``'s reading."""

from port_bench.metrics.device_ops_per_step import read  # noqa: F401
