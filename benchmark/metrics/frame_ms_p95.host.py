"""frame_ms_p95.host: `frame_ms_p95`'s tail (the 95th percentile, nearest
rank, over the window's frames of the host clock from a frame's dispatch
to the synchronize that ends it, a fleet's batched frame one sample) as a
per-layer metric of the step driver, in the cells where the host between
the graph replays paces it (`BENCHMARK.json` lists them)."""

import tail


def read(run):
    return tail.p95(run.untraced_ms) if run.untraced_ms else None
