"""Timing and profiling of the port's steps on the card.

Shared by `chip_smoke.py` and `bench_torch.py`: the card's name and power
limit, a tracker driven frame by frame with a synchronize after each
frame (the port has no whole-sequence program: every frame is dispatched
from the host, its WORKING segments as CUDA graphs by default), repeat
runs that must equal the first bit for bit, and a torch.profiler window
read from its chrome trace.

Every time here is a host clock around work that ends in
`torch.cuda.synchronize()`, or the device time of the profiler's kernel
records. `drive` and `timed_runs` also run on the CPU (`device="cpu"`,
the tests' small runs); the profile needs the card.
"""

from __future__ import annotations

import bisect
import json
import os
import statistics
import subprocess
import time
from typing import NamedTuple

import torch

# where the profile tables go: the output directory at the checkout's root
OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "chiprun_out")


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    """The card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


class Run(NamedTuple):
    """One pass of a tracker over a sequence (see `drive`)."""
    step: object
    states: list
    Rs: list
    ts: list
    vios: list
    frame_ms: list
    new_kf: list
    wall_ms: float


def synchronize(device="cuda"):
    """Waits for the card when `device` is a CUDA device (a CPU run has
    nothing to wait for)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def drive(new_tracker, feeds, device="cuda", on_frame=None) -> Run:
    """A fresh tracker from `new_tracker()` passed once over the sequence's
    per-frame inputs: the step, per-frame states, poses, VIO flags (VIP),
    ms (host clock around a step that ends in a synchronize) and keyframe
    slots, and the host clock of the whole loop (`wall_ms`, from the first
    frame's start to the last frame's synchronize). No reference to the
    initial state outlives its first frame, so peak memory is the step's
    own. The poses kept are the step's own output tensors: this relies on
    a step's outputs being fresh tensors that no later frame writes (a
    graphed step copies them out of its graphs' static outputs).
    `on_frame(step, state, out)`, when given, is called after each frame's
    timing."""
    st, step = new_tracker()
    states, Rs, ts, vios, frame_ms, new_kf = [], [], [], [], [], []
    t0 = time.perf_counter()
    for x in feeds:
        t1 = time.perf_counter()
        st, out = step(st, x)
        synchronize(device)
        frame_ms.append((time.perf_counter() - t1) * 1e3)
        states.append(int(out.state))
        vios.append(bool(getattr(out, "vio_ok", False)))
        new_kf.append(int(out.new_kf))
        Rs.append(out.Rcw)
        ts.append(out.tcw)
        if on_frame is not None:
            on_frame(step, st, out)
    wall_ms = (time.perf_counter() - t0) * 1e3
    return Run(step, states, Rs, ts, vios, frame_ms, new_kf, wall_ms)


def same_run(a: Run, b: Run, n: int | None = None) -> bool:
    """Whether two runs give the same states and poses bit for bit over
    their first `n` frames (all of them when None)."""
    n = len(a.states) if n is None else n
    return a.states[:n] == b.states[:n] and all(
        torch.equal(x, y) for x, y in zip(a.Rs[:n] + a.ts[:n], b.Rs[:n] + b.ts[:n]))


def timed_runs(new_tracker, feeds, first: Run, repeats: int, device="cuda"):
    """`repeats` more runs after `first` (a `drive` result); each must give
    the same states and poses bit for bit. Returns the run medians of the
    per-frame ms over frames 3 on."""
    meds = [statistics.median(first.frame_ms[2:])]
    for _ in range(repeats):
        r = drive(new_tracker, feeds, device)
        meds.append(statistics.median(r.frame_ms[2:]))
        if not same_run(r, first):
            raise AssertionError("a repeat run of the step differs from the main run")
    return meds


def trace_events(prof):
    """The chrome-trace events of a finished torch.profiler session (the
    file is exported into the kernels' build directory, read and removed)."""
    from uvipslam_torch import kernels

    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    path = os.path.join(kernels.BUILD_DIR, f"_trace_{os.getpid()}.json")
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh)["traceEvents"]
    finally:
        if os.path.exists(path):
            os.remove(path)


# the host's launch calls: a kernel each, or a whole CUDA graph (whose
# kernels the trace records as device events of that one call)
GRAPH_LAUNCH_NAMES = ("cudaGraphLaunch", "cuGraphLaunch")
LAUNCH_NAMES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                *GRAPH_LAUNCH_NAMES)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def trace_summary(events):
    """The numbers a profile reports, from a torch.profiler trace's events
    (its chrome-trace `traceEvents`; reading them takes a second where
    `key_averages()` takes up to half a minute): {name: [count, µs]} of the
    device events, {name: [count, self µs]} of the host events (their
    time less that of the events nested in them on the same thread),
    {span: [count, host µs, device µs, launch calls]} of the `step.*`
    spans (the device time of the kernels launched inside them and the
    host's launch calls made inside them) and the host's launch calls
    (kernel launches and graph launches, LAUNCH_NAMES)."""
    dev, host, spans, launch_at, threads = {}, {}, {}, {}, {}
    dev_events, launch_events = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            c = dev.setdefault(e["name"], [0, 0.0])
            c[0] += 1
            c[1] += e["dur"]
            dev_events.append(e)
        elif cat in HOST_CATS:
            threads.setdefault((e["pid"], e["tid"]), []).append(e)
            if cat in ("cuda_runtime", "cuda_driver"):
                launch_at[e.get("args", {}).get("correlation")] = ((e["pid"], e["tid"]), e["ts"])
    launches = 0
    span_at = {}
    for key, evs in threads.items():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack, self_us = [], [e["dur"] for e in evs]
        for i, e in enumerate(evs):
            while stack and evs[stack[-1]]["ts"] + evs[stack[-1]]["dur"] <= e["ts"] + 1e-3:
                stack.pop()
            if stack:
                self_us[stack[-1]] -= e["dur"]
            stack.append(i)
        for e, us in zip(evs, self_us):
            h = host.setdefault(e["name"], [0, 0.0])
            h[0] += 1
            h[1] += us
            if e["name"] in LAUNCH_NAMES:
                launches += 1
                launch_events.append((key, e["ts"]))
        sp = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in evs
                    if e.get("cat") == "user_annotation" and e["name"].startswith("step."))
        for t0, t1, name in sp:
            c = spans.setdefault(name, [0, 0.0, 0.0, 0])
            c[0] += 1
            c[1] += t1 - t0
        span_at[key] = (sp, [x[0] for x in sp])

    def enclosing(at):
        """The spans around a host event at (thread, ts)."""
        if at is None or at[0] not in span_at:
            return []
        sp, starts = span_at[at[0]]
        return [name for t0, t1, name in sp[:bisect.bisect_right(starts, at[1])]
                if t0 <= at[1] <= t1]

    for e in dev_events:
        for name in enclosing(launch_at.get(e.get("args", {}).get("correlation"))):
            spans[name][2] += e["dur"]
    for at in launch_events:
        for name in enclosing(at):
            spans[name][3] += 1
    return dev, host, spans, launches


class ProfileGap(AssertionError):
    """The profiler's trace lacks what a profile reads: no device time, or
    no `step.propagate` span (`step.graph.B` on a graphed frame; the trace
    is known to drop records)."""


def profile_phase(step, st, feeds, start, n, out_name, log=log):
    """torch.profiler over frames start..start+n-1 from state `st`: device
    busy time and the top operators by device and by host time (tables to
    OUT_DIR/<out_name>), host and device time per `step.*` span, the host's
    launch calls per frame (`launches_per_frame`: kernel launches plus
    graph launches, the latter also alone) apart from the kernels the
    device ran (`device_kernels_per_frame`), the hand kernels' launches
    in the trace beside their counters' change over the window
    (`counted`: on a graphed frame each replay's captured launches, so
    the trace is what holds them to the kernels the device ran) and
    device µs per launch, and the graph captures made in the window.
    Raises ProfileGap when the trace holds no device time or no
    `step.propagate` span (`step.graph.B` when the frame's WORKING body
    was a graph's replay)."""
    from torch.profiler import ProfilerActivity, profile

    from uvipslam_torch.ops import klt

    seg = getattr(step, "segments", None)          # none on a fleet's step
    captures = seg.captures if seg is not None else 0
    counted = (klt.patch_launches, klt.refine_launches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in range(start, start + n):
            st, _ = step(st, feeds[f])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3   # the profiler's teardown excluded
    counted = (klt.patch_launches - counted[0], klt.refine_launches - counted[1])
    captures = (seg.captures if seg is not None else 0) - captures
    t1 = time.perf_counter()
    os.makedirs(OUT_DIR, exist_ok=True)
    events = trace_events(prof)
    dev, host, span_us, launches = trace_summary(events)
    post_s = time.perf_counter() - t1

    device_ms = sum(us for _, us in dev.values()) / 1e3
    kernels = sum(c for c, _ in dev.values())
    graph_launches = sum(host.get(k, [0])[0] for k in GRAPH_LAUNCH_NAMES)
    spans = {k: dict(host_ms=h / 1e3 / n, device_ms=d / 1e3 / n, calls=c / n,
                     launches=la / n) for k, (c, h, d, la) in span_us.items()}
    top_dev = sorted(dev.items(), key=lambda kv: -kv[1][1])
    top_cpu = sorted(host.items(), key=lambda kv: -kv[1][1])
    with open(os.path.join(OUT_DIR, out_name), "w") as fh:
        fh.write(f"frames {start}-{start + n - 1}; device events by device time (count, ms)\n")
        fh.writelines(f"{c:8d} {us / 1e3:10.3f}  {k}\n" for k, (c, us) in top_dev[:60])
        fh.write("\nhost events by self time (count, ms)\n")
        fh.writelines(f"{c:8d} {us / 1e3:10.3f}  {k}\n" for k, (c, us) in top_cpu[:40])
    if device_ms <= 0:
        raise ProfileGap("the profiler saw no device time")
    log(f"  frames {start}-{start + n - 1} under torch.profiler, which slows the host: "
        f"wall {wall_ms / n:.1f} ms/frame, device busy {device_ms / n:.2f} ms/frame, "
        f"{kernels / n:.0f} device kernels and {launches / n:.0f} host launch calls/frame "
        f"({graph_launches / n:.0f} of them graph launches); "
        f"{len(events)} trace events read in {post_s:.1f} s")
    log("  top device: " + "; ".join(f"{k[:60]} {us / 1e3 / n:.3f} ms x{c // n}"
                                     for k, (c, us) in top_dev[:8]))
    log("  top host: " + "; ".join(f"{k[:40]} {us / 1e3 / n:.2f} ms x{c // n}"
                                   for k, (c, us) in top_cpu[:8]))
    log("  per phase (ms/frame, host under the profiler / device): " + "; ".join(
        f"{k[5:]} {v['host_ms']:.1f} / {v['device_ms']:.2f} (x{v['calls']:.2f})"
        for k, v in sorted(spans.items(), key=lambda kv: -kv[1]["host_ms"])))
    name = "step.propagate" if "step.propagate" in spans else "step.graph.B"
    prop = spans.get(name)
    if prop is None:
        raise ProfileGap("no step.propagate or step.graph.B span in the profile window")
    log(f"  {launches / n:.0f} host launch calls per frame; {name} host {prop['host_ms']:.2f} "
        f"ms / device {prop['device_ms']:.3f} ms per frame")
    # the hand-written kernels' own device time per launch on the path
    ours = {}
    for name, n_counted in zip(("extract_patches_kernel", "anchor_refine_kernel"), counted):
        c = sum(v[0] for k, v in dev.items() if name in k)
        us = sum(v[1] for k, v in dev.items() if name in k)
        ours[name] = dict(launches=c, counted=n_counted, device_us_per_launch=us / max(1, c))
    log("  hand kernels on the path: " + "; ".join(
        f"{k} {v['launches']} launches in the trace ({v['counted']} counted), "
        f"{v['device_us_per_launch']:.2f} us device each" for k, v in ours.items())
        + f"; {captures} graph captures in the window")
    return dict(frames=n, post_processing_s=post_s,
                wall_ms_per_frame_profiled=wall_ms / n, device_ms_per_frame=device_ms / n,
                device_kernels_per_frame=kernels / n, launches_per_frame=launches / n,
                graph_launches_per_frame=graph_launches / n, phases=spans, hand_kernels=ours,
                captures_in_window=captures)
