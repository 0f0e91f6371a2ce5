"""device_idle_share: 100 x (1 - the device's busy time over the traced
frames / the host clock's time of the same frames in the window's
untraced dives). The busy time is the union of the device's operation
intervals in the device-only profile of those frames; the untraced time
is the mean over the window's dives, so the profiler's slowing of the
host does not count as idle."""


def read(run):
    if not run.trace or not run.untraced_same_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_ns / 1e9 / run.untraced_same_s)
