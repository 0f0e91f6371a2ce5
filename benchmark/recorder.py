#!/usr/bin/env python3
"""The program's own spans over one cell: a development aid beside
`run.py`, not part of the benchmark's result line.

    python3 benchmark/recorder.py --workload mono.dive --seed 7 --seconds 30

Runs `run.py`'s cell as `--trace 1` runs it (set-up, window, traced dive,
judge and every metric read as there) with the step's recorder
(`uvipslam_torch.utils.spans.Spans`, the step's `spans`) on where
nothing that `run.py` reads is timed:

- host only through set-up, stopped at the window's start: the warm-up's
  captures (`step.graph.capture`) and the process's first VIO init;
- host only over the traced dive's device-only frames (`Tracing`'s
  a0..a1-1): every idle stretch of the device there, split by the
  innermost recorded span the host was in, on the profiler's clock;
- after everything `run.py` reads, one more whole dive of the traced
  dive's dives with the replays timed by events and no profiler: each
  frame's step call and its closing synchronize timed apart.

Prints `run.py`'s line with `recorder` (the readers `metrics/<name>.py`
of `RECORDED`, given `run.py`'s fields and `fields`' new ones) and
`recorder_checks` (coverage, cost, device ratio) added as the last line
of standard output, and on standard error the recorder dive's segments
(host, read-wait and device ms per step call) and the traced frames'
idle ms per span.

A later `run.py` takes the recorder in with these hooks as its own: the
set-up recording around `run_cell`'s warm-up, `RecordedTracing` in place
of `Tracing`, `recorder_dive` after the metrics, and `fields` in `run`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import types

import run as harness

# the metrics the recorder gives: name -> unit
RECORDED = {"host_busy_ms_per_frame": "ms", "driver_idle_share": "%",
            "segment_host_ms_per_frame": "ms", "setup_capture_s": "s",
            "graph_device_ms_per_frame": "ms", "first_vio_init_s": "s"}
REPLAY = "step.graph."     # a replay's span: step.graph.<segment> or step.graph.scan.<name>


def spans_of(entry):
    """The step's recorder, None for a program without one."""
    return getattr(entry.step, "spans", None)


# -- the timeline ------------------------------------------------------------
def innermost(records) -> list:
    """(start, end, name) stretches, in time order, in which the record
    `name` was the innermost open one (its self time), from records that
    nest (each inside its parent)."""
    kids = [[] for _ in records]
    tops = []
    for i, r in enumerate(records):
        (kids[r.parent] if r.parent >= 0 else tops).append(i)
    out = []

    def walk(i):
        r = records[i]
        at = r.start_ns
        for k in sorted(kids[i], key=lambda k: records[k].start_ns):
            if records[k].start_ns > at:
                out.append((at, records[k].start_ns, r.name))
            walk(k)
            at = max(at, records[k].end_ns)
        if r.end_ns > at:
            out.append((at, r.end_ns, r.name))

    for i in tops:
        walk(i)
    out.sort()
    return out


def busy_union(device) -> list:
    """The union of device intervals (start ns, duration ns), sorted."""
    out = []
    for s, d in sorted(device):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s + d)
        else:
            out.append([s, s + d])
    return out


def idle_by_span(records, device) -> dict:
    """The device's idle ns inside the top-level spans (the step calls),
    split by the innermost span the host was in; "outside" the idle ns
    between the first call's start and the last call's end that falls in
    no call. `device` holds (start ns, duration ns) per operation."""
    tops = [r for r in records if r.parent < 0]
    if not tops:
        return {}
    t0, t1 = tops[0].start_ns, max(r.end_ns for r in tops)
    idle, at = [], t0
    for a, b in busy_union(device):
        if b <= at:
            continue
        if a > at:
            idle.append((at, min(a, t1)))
        at = max(at, b)
        if at >= t1:
            break
    if at < t1:
        idle.append((at, t1))
    idle = [(a, b) for a, b in idle if b > a]
    out: dict = {}
    inside = 0
    segs = innermost(records)
    j = 0
    for a, b in idle:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            s0, s1, name = segs[k]
            ov = min(b, s1) - max(a, s0)
            if ov > 0:
                out[name] = out.get(name, 0) + ov
                inside += ov
            k += 1
    out["outside"] = sum(b - a for a, b in idle) - inside
    return out


def per_call(records) -> list:
    """Per top-level record (a step call): its host ns and the device ns
    of the replays inside it."""
    top = [0] * len(records)
    calls = []
    for i, r in enumerate(records):
        if r.parent < 0:
            top[i] = len(calls)
            calls.append([r.end_ns - r.start_ns, 0.0])
        else:
            top[i] = top[r.parent]
            if r.device_ns:
                calls[top[i]][1] += r.device_ns
    return calls


def segment_table(records, calls: int) -> dict:
    """Per replayed graph (`step.graph.<segment>`): replays, host ns (its
    replay's self time, its prep and copies), read ns (the reads that
    follow it in its step call) and device ns, all per step call."""
    rows: dict = {}
    pending, last = [], None
    for r in records:
        if r.parent < 0:
            pending, last = [], None
            continue
        dur = r.end_ns - r.start_ns
        if r.name.startswith(REPLAY) and r.name != "step.graph.capture":
            row = rows.setdefault(r.name, dict(replays=0, host=0.0, read=0.0, device=0.0))
            row["replays"] += 1
            row["host"] += dur + sum(pending)
            row["device"] += r.device_ns or 0.0
            pending, last = [], row
        elif r.name == "graph.prep":
            pending.append(dur)
        elif r.name == "graph.copy":
            if pending or last is None:
                pending.append(dur)
            else:
                last["host"] += dur
        elif r.name == "step.read" and last is not None:
            last["read"] += dur
    return {k: {c: v / calls for c, v in row.items()} for k, row in sorted(rows.items())}


# -- the hooks ---------------------------------------------------------------
class RecordedTracing(harness.Tracing):
    """`Tracing` with the recorder on, host only, over the device-only
    frames a0..a1-1; `records` holds them, `tr` the read trace."""

    spans = None           # set by the recorder

    def before(self, f, st):
        super().before(f, st)
        if f == self.a0 and self.spans is not None:
            self.spans.start()

    def after(self, f):
        if f == self.a1 - 1 and self.spans is not None:
            self.records = self.spans.stop()
        super().after(f)

    def read(self):
        self.tr = super().read()
        return self.tr


class Recorder:
    """The hooks into one `run_cell` and the recorder dive after it."""

    def __init__(self):
        self.entry = self.spans = self.setup = self.window = None
        self.ids = []
        self.window_starts = 0
        self.tracing = None

    def on_entry(self, entry):
        self.entry = entry
        self.spans = spans_of(entry)
        if self.spans is not None:
            self.spans.start()
        start = entry.start

        def noted(ids):
            self.ids.append(list(ids))
            return start(ids)

        entry.start = noted

    def run_dives(self, real):
        def wrapped(*args, **kwargs):
            window = kwargs.get("keep", True)
            if window and self.setup is None:
                self.setup = self.spans.stop() if self.spans is not None else []
                self.window_starts = len(self.ids)
            out = real(*args, **kwargs)
            if window:
                self.window = out
            return out
        return wrapped

    def make_tracing(self, *a):
        self.tracing = RecordedTracing(*a)
        self.tracing.spans = self.spans
        return self.tracing

    def recorder_dive(self, frames: int, sync) -> dict:
        """Two more whole dives of the traced dive's dives: one with the
        recorder off (`bare_ms`, its frames' host ms), then one with the
        replays timed: per frame the step call's and its synchronize's
        host ms."""
        def dive(record):
            st, frame = self.entry.start(self.ids[-1])
            call_ms, sync_ms = [], []
            if record:
                self.spans.start(events=True)
            for f in range(frames):
                t0 = time.perf_counter()
                st, _ = frame(st, f)
                t1 = time.perf_counter()
                sync()
                call_ms.append((t1 - t0) * 1e3)
                sync_ms.append((time.perf_counter() - t1) * 1e3)
            return call_ms, sync_ms

        bare = dive(False)
        call_ms, sync_ms = dive(True)
        records = self.spans.stop()
        return dict(records=records, totals=self.spans.totals(), call_ms=call_ms,
                    sync_ms=sync_ms, bare_ms=[a + b for a, b in zip(*bare)])


def fields(rec: Recorder, dive: dict) -> types.SimpleNamespace:
    """What the recorder's metric readers read (the fields a later
    `run.py` adds to its `run`)."""
    tr = rec.tracing
    device = [(s, d) for _, s, d, _ in tr.tr.device] if tr and getattr(tr, "tr", None) else []
    traced = getattr(tr, "records", None)
    return types.SimpleNamespace(
        spans_setup=rec.setup, spans_dive=dive["totals"], dive_calls=len(dive["call_ms"]),
        idle_by_span=idle_by_span(traced, device) if traced and device else None)


def graph_extents(device) -> float:
    """The ns from first start to last end of each replay's device
    operations (those sharing one launch's correlation id, more than one
    of them), summed: a replay's time on the device with the gaps between
    its kernels. `device` holds `devtrace`'s (name, start, duration,
    record) per operation."""
    groups: dict = {}
    for _, s, d, e in device:
        cid = getattr(e, "correlation_id", lambda: None)()
        if cid:
            g = groups.setdefault(cid, [s, s + d, 0])
            g[0], g[1], g[2] = min(g[0], s), max(g[1], s + d), g[2] + 1
    return float(sum(b - a for a, b, n in groups.values() if n > 1))


def checks(rec: Recorder, dive: dict, frames: int) -> dict:
    """Coverage (the step calls' spans over the host clock around them,
    less their synchronize), cost (the recorder dive's mean frame ms over
    the window's dives of the same dives, and over the bare dive just
    before it) and the device ratio (the replays' event time over the
    device-only profile's busy time, the same frames; beside it, over
    the profile's replays' extents, which hold the gaps between their
    kernels)."""
    import numpy as np

    calls = per_call(dive["records"])
    out = dict(coverage=sum(c[0] for c in calls) / 1e6 / sum(dive["call_ms"]))
    _, frame_ms, _, _, _ = rec.window
    per_dive = np.asarray(frame_ms).reshape(-1, frames)
    ids = rec.ids[rec.window_starts:rec.window_starts + len(per_dive)]
    same = [d for d, i in zip(per_dive, ids) if i == rec.ids[-1]]
    mine = np.asarray(dive["call_ms"]) + np.asarray(dive["sync_ms"])
    if same:
        out["cost"] = float(mine.mean() / np.mean(same))
        out["cost_dives"] = len(same)
    out["cost_vs_bare"] = float(mine.mean() / np.mean(dive["bare_ms"]))
    tr = rec.tracing
    if tr is not None and getattr(tr, "tr", None) is not None and tr.tr.busy_ns:
        ev = sum(c[1] for c in calls[tr.a0:tr.a1])
        out["device_ratio"] = ev / tr.tr.busy_ns
        ext = graph_extents(tr.tr.device)
        if ext:
            out["device_over_extents"] = ev / ext
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    harness.set_environment()
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    _, conf, traffic = harness.find_cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available():
        harness.note("the recorder needs a CUDA device")
        return 2
    rec = Recorder()
    real_dives, real_tracing = harness.run_dives, harness.Tracing
    harness.run_dives, harness.Tracing = rec.run_dives(real_dives), rec.make_tracing
    try:
        result = harness.run_cell(conf, traffic, [args.seed], args.seconds, trace=True,
                                  metrics=harness.cell_metrics(bench, args.workload, True),
                                  on_entry=rec.on_entry)
    finally:
        harness.run_dives, harness.Tracing = real_dives, real_tracing
    if rec.spans is None:
        harness.note("the program has no recorder")
        print(json.dumps(result), flush=True)
        return 0
    frames = int(traffic["frames"])
    dive = rec.recorder_dive(frames, torch.cuda.synchronize)
    run = fields(rec, dive)
    shown = {}
    for name, unit in RECORDED.items():
        v = harness.metric_reader(name)(run)
        if v is not None:
            shown[name] = {"value": float(v), "unit": unit}
    result["recorder"] = shown
    result["recorder_checks"] = checks(rec, dive, frames)
    calls = run.dive_calls
    harness.note(f"recorder dive: {calls} step calls, {sum(dive['call_ms']):.1f} ms in calls, "
                 f"{sum(dive['sync_ms']):.1f} ms in their synchronize")
    harness.note("segment: replays / host ms / read-wait ms / device ms, per step call")
    for name, row in segment_table(dive["records"], calls).items():
        harness.note(f"  {name}: {row['replays']:.3f} / {row['host'] / 1e6:.4f} / "
                     f"{row['read'] / 1e6:.4f} / {row['device'] / 1e6:.4f}")
    tot = dive["totals"]
    harness.note("recorder dive spans: name count host_ms self_ms device_ms: " + "; ".join(
        f"{k} {t['count']} {t['host_ns'] / 1e6:.2f} {t['self_ns'] / 1e6:.2f} "
        f"{t.get('device_ns', 0.0) / 1e6:.2f}"
        for k, t in sorted(tot.items(), key=lambda kv: -kv[1]["self_ns"])))
    if run.idle_by_span:
        harness.note(f"traced frames {rec.tracing.a0}-{rec.tracing.a1 - 1}: idle ms per span "
                     "(device-only profile, recorder on): " + "; ".join(
                         f"{k} {v / 1e6:.3f}" for k, v in sorted(run.idle_by_span.items(),
                                                                key=lambda kv: -kv[1])))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
