"""host_reads_per_frame: the step's device-to-host reads (`host_syncs` of
the step or fleet step) over the window, per step call."""


def read(run):
    return run.host_syncs / run.step_calls
