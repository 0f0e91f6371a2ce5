"""frames_per_s: the frames completed by all streams over the whole
window, per second of the host clock (a fleet's batched frame counts as
its number of streams)."""


def read(run):
    return run.stream_frames / run.window_s
