"""driver_idle_share: of the device's idle time inside the step calls over
the traced dive's device-only frames, the share in which the host was in
the step driver's own code: the self time of `step.call` (its Python
between segments), of `graph.prep` and `graph.copy`, and of the replays
`step.graph.<segment>` (their launch), not of `step.read` (a host read's
wait) nor of an eager `step.<stage>`. The recorder (`recorder.py`) names
each idle stretch by the innermost span on the profiler's clock. Nothing
without the program's recorder."""


def read(run):
    idle = getattr(run, "idle_by_span", None)
    if not idle:
        return None
    inside = {k: v for k, v in idle.items() if k != "outside"}
    total = sum(inside.values())
    if not total:
        return None
    driver = sum(v for k, v in inside.items()
                 if k == "step.call" or k.startswith("graph.")
                 or (k.startswith("step.graph.") and k != "step.graph.capture"))
    return 100.0 * driver / total
