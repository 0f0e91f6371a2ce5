"""host_busy_ms_per_frame: the host's busy time inside the step per step
call, from the recorder dive (`recorder.py`): the `step.call` spans' host
ns less the `step.read` ns inside them (the waits of the host reads), over
the dive's step calls. Nothing without the program's recorder."""


def read(run):
    t = getattr(run, "spans_dive", None)
    if not t or "step.call" not in t:
        return None
    busy = t["step.call"]["host_ns"] - t.get("step.read", {}).get("host_ns", 0)
    return busy / 1e6 / run.dive_calls
