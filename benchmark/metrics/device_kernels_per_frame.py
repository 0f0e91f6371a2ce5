"""device_kernels_per_frame: the kernels the device ran in the traced
dive, per step call."""


def read(run):
    return run.trace.kernels / run.traced_calls if run.trace else None
