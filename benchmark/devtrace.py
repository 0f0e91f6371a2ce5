"""Reading a torch.profiler window: the device's operations, the host's
launch calls and the program's `step.*` spans, straight from the
profiler's event list (no trace file is written).

`summarize(prof)` returns a `Trace` of the window that the harness's span
`bench.traced` marks, or with `window_ns` of a profile of the device's
activity alone (no host spans), over all of it, `window_ns` the host
clock's span of the profiled frames (`launches` reads a short profile's
kernel records with their launch shapes):

- `device`: every device operation (kernel, copy, fill) as (name, start
  ns, duration ns, the profiler's record);
- `kernels`: the number of kernels among them;
- `launches`: the host's launch calls (a kernel launch each, or a whole
  CUDA graph's);
- `busy_ns`: the union of the device operations' intervals inside the
  window, and `window_ns` its length;
- `gaps`: the ten longest idle stretches of the device inside the
  window, as (the innermost `step.*` span the host was in when it began,
  or "host", seconds); none without the span;
- `top_ops`: device time by operation name, largest first.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

# the host's launch calls: a kernel each, or a whole CUDA graph
LAUNCH_NAMES = frozenset(("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                          "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch"))
COPY_PREFIXES = ("Memcpy", "Memset")


@dataclasses.dataclass
class Trace:
    device: list
    kernels: int
    launches: int
    busy_ns: float
    window_ns: float
    gaps: list
    top_ops: list


def launches(prof, names) -> list:
    """The kernel records whose name holds one of `names`, as (name,
    duration ns, launch arguments: grid, block, shared memory), in the
    order they ran, from the profile's trace file (the event list carries
    no launch shapes). The file is written under the temporary directory
    and removed."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    own = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"
                  and any(n in e["name"] for n in names)), key=lambda e: float(e["ts"]))
    return [(e["name"], float(e["dur"]) * 1e3, e.get("args", {})) for e in own]


def _annotation(e) -> bool:
    """Whether a device-side record is a host span mirrored on the device's
    timeline (a `record_function` span), not an operation."""
    try:
        return bool(e.is_user_annotation())
    except AttributeError:
        return e.name().startswith(("step.", "bench.", "loop."))


def summarize(prof, span: str = "bench.traced", window_ns: float | None = None) -> Trace:
    events = prof.profiler.kineto_results.events()
    device, spans = [], []
    launches = 0
    t0_ns = t1_ns = None
    for e in events:
        if e.name() == span and not str(e.device_type()).endswith("CUDA"):
            t0_ns, t1_ns = e.start_ns(), e.start_ns() + e.duration_ns()
        kind = str(e.device_type())
        if kind.endswith("CUDA") and not _annotation(e):
            device.append((e.name(), e.start_ns(), e.duration_ns(), e))
        elif e.name() in LAUNCH_NAMES:
            launches += 1
        elif e.name().startswith("step."):
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    device.sort(key=lambda d: d[1])
    if window_ns is not None:
        if device:
            t0_ns = device[0][1]
            t1_ns = max(s + d for _, s, d, _ in device)
        else:
            t0_ns = t1_ns = 0
    elif t0_ns is None:
        raise ValueError(f"no {span!r} span in the profile")
    kernels = sum(1 for d in device if not d[0].startswith(COPY_PREFIXES))

    # busy: the union of the device intervals, clipped to the window
    busy, gaps = 0.0, []
    cur0 = cur1 = None
    idle_from = t0_ns
    for _, s, dur, _ in device:
        a, b = max(s, t0_ns), min(s + dur, t1_ns)
        if b <= a:
            continue
        if cur1 is None or a > cur1:
            if cur1 is not None:
                busy += cur1 - cur0
            if a > idle_from:
                gaps.append((idle_from, a))
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
        idle_from = cur1
    if cur1 is not None:
        busy += cur1 - cur0
    if t1_ns > idle_from:
        gaps.append((idle_from, t1_ns))

    spans.sort()

    def host_in(t):
        inner = None
        for s0, s1, name in spans:
            if s0 > t:
                break
            if s1 >= t and (inner is None or s0 >= inner[0]):
                inner = (s0, name)
        return inner[1] if inner else "host"

    gaps.sort(key=lambda g: g[0] - g[1])
    named = [] if window_ns is not None else [(host_in(a), (b - a) / 1e9) for a, b in gaps[:10]]
    by_name = {}
    for name, _, dur, _ in device:
        by_name[name] = by_name.get(name, 0.0) + dur / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return Trace(device=device, kernels=kernels, launches=launches, busy_ns=busy,
                 window_ns=float(window_ns if window_ns is not None else t1_ns - t0_ns),
                 gaps=named, top_ops=top)
