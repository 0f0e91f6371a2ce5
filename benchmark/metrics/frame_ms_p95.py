"""frame_ms_p95: the 95th percentile (nearest rank) over the window's
frames of the host clock from a frame's dispatch to the synchronize that
ends it, a fleet's batched frame one sample. An end-to-end metric in the
cells whose traced frames keep the card busy at least half the time
(`device_idle_share`); where the host paces the tail it is the per-layer
`frame_ms_p95.host`."""

import tail


def read(run):
    return tail.p95(run.untraced_ms) if run.untraced_ms else None
