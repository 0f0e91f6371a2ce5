"""segment_host_ms_per_frame: the host's work around the graph replays per
step call, from the recorder dive (`recorder.py`): the `graph.prep` spans
(the inputs' leaves, layouts and the graph's lookup) and the `graph.copy`
spans (the copies into the static inputs and the fresh outputs' copy-out)
of every segment and scan, over the dive's step calls. Nothing without
the program's recorder."""


def read(run):
    t = getattr(run, "spans_dive", None)
    if not t or "step.call" not in t:
        return None
    ns = sum(t.get(k, {}).get("host_ns", 0) for k in ("graph.prep", "graph.copy"))
    return ns / 1e6 / run.dive_calls
