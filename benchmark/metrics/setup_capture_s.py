"""setup_capture_s: the seconds set-up spends capturing graphs, their
warm-ups included: the `step.graph.capture` spans that the recorder keeps
over set-up (`recorder.py`; the span counterpart of
`Segments.capture_seconds`). Nothing without the program's recorder."""


def read(run):
    recs = getattr(run, "spans_setup", None)
    if not recs:
        return None
    return sum(r.end_ns - r.start_ns for r in recs if r.name == "step.graph.capture") / 1e9
