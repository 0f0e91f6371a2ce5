"""host_launch_calls_per_frame: the host's kernel and graph launch calls
in the traced dive, per step call."""


def read(run):
    return run.trace.launches / run.traced_calls if run.trace else None
