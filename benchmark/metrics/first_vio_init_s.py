"""first_vio_init_s: the process's first VIO init outside its captures:
the first `step.vio_init` span that the recorder keeps over set-up
(`recorder.py`), less the `step.graph.capture` spans inside it, in s.
Nothing where set-up runs no VIO init or without the program's
recorder."""


def read(run):
    recs = getattr(run, "spans_setup", None)
    first = next((i for i, r in enumerate(recs or []) if r.name == "step.vio_init"), None)
    if first is None:
        return None

    def inside(i):
        while i >= 0:
            if i == first:
                return True
            i = recs[i].parent
        return False

    r = recs[first]
    caps = sum(c.end_ns - c.start_ns for i, c in enumerate(recs[first + 1:], first + 1)
               if c.name == "step.graph.capture" and inside(i))
    return (r.end_ns - r.start_ns - caps) / 1e9
