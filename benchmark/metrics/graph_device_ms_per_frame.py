"""graph_device_ms_per_frame: the device time of the graph replays per
step call, from the recorder dive (`recorder.py`): each replay's time
between two timing events recorded on its stream before and after it,
summed over the whole dive, over its step calls. Nothing without the
program's recorder or where no replay was timed."""


def read(run):
    t = getattr(run, "spans_dive", None)
    if not t:
        return None
    timed = [v["device_ns"] for v in t.values() if "device_ns" in v]
    return sum(timed) / 1e6 / run.dive_calls if timed else None
