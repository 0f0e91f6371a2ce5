#!/usr/bin/env python3
"""The benchmark of uvipslam_torch, the PyTorch and CUDA port, on NVIDIA GPUs.

    python3 benchmark/run.py --workload vip.dive --seed 7 --seconds 30 --trace 0

Runs one cell of `BENCHMARK.json` (its `workloads`) from the root of a
checkout and prints, as the last line of standard output, one JSON object:
`correct`, `attempted` and `failed` (stream-frames in the window, and
those whose tracking state is LOST), `metrics` (the cell's end-to-end
metrics with `--trace 0`, its per-layer metrics with `--trace 1`), `device`
and, last, `checks`: each number that decided `correct` beside its limit.
With `--trace 1` also `breakdown`: the device operations that took most
time and the longest idle gaps of the device, named by the program's span
in which the host was busy.

Everything a cell needs is found by name: its configuration's file (the
tracker's settings, the sequence's sizes, the limits), the traffic file
`traffic/<name>.json` (streams, dive length, scenes), the program's entry
`entries/<entry>.py`, the plain reference that judges it
`references/<reference>.py`, and one reader per metric
`metrics/<metric>.py`. A later cell, configuration or metric is added by
adding such files and entries.

A run: the traffic's dives, a fixed set like a recorded dataset, are made
on the card (`dives.py`) and uploaded once; `--seed` orders them (which
dive each stream starts from) and draws the frames the judge reads. One
step object of the program serves every dive, each dive from a fresh
state; set-up ends after one whole warm-up dive of the cell, which
captures the graphs of the cell's keys. The window then replays dives
back to back (a fleet's streams each a different dive, in lockstep) and
closes at the first dive boundary at or after `--seconds`; each frame is
timed from its dispatch to the `torch.cuda.synchronize()` that ends it.
After the window: the peak memory, the program's state freed, then the
judge (`references/`) compares what the window produced with the plain
reference on the dives' own inputs. With `--trace 1` one more dive runs
after the window, the traffic's `traced_frames` of it under
torch.profiler (`Tracing`): the device's activity alone over all but the
last few of them, whose busy time `device_idle_share` takes against the
same frames' host time in the window's untraced dives, then the host's
spans too over the last few, which name the idle gaps and give the hand
kernels' launch shapes.

A development aid (not used by the benchmark's checks): `--seeds a,b,...`
runs one window per seed in one process (one set-up) and prints, per
seed, a JSON line with the checks, the control's (the reference in TF32
in the program's place, which has to fail them) and the metrics.

Exits non-zero and prints no result without enough CUDA devices, when the
program is not the checkout's own, or when `jax`, `jaxlib`, `flax` or
`uvipslam_tpu` is loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "uvipslam_tpu")
LOST = 3


def note(*a):
    print("run.py:", *a, file=sys.stderr, flush=True)


def set_environment():
    """Caches at fixed paths inside the checkout; few host threads."""
    cache = os.path.join(BENCH, "_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(k, "2")
    for p in (BENCH, ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is a forbidden one."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# -- the benchmark's files, found by name ------------------------------------
def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def find_cell(bench: dict, name: str):
    """(workload, configuration, traffic) of the cell `name`."""
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"run.py: no workload {name!r} in BENCHMARK.json")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    conf = load_json(os.path.join(ROOT, c["file"]))
    traffic = load_json(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
    return w, conf, traffic


def cell_metrics(bench: dict, name: str, trace: bool) -> list:
    """The cell's end-to-end metrics (trace off) or per-layer ones (on)."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if name in m.get("workloads", [name])]


def metric_reader(name: str):
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# -- the window --------------------------------------------------------------
def field(tree, path: str):
    for part in path.split("."):
        tree = getattr(tree, part)
    return tree


def dive_ids(k: int, streams: int, n: int, offset: int) -> list:
    """The dives of fleet dive k: stream i replays dive (i + k + offset) % n."""
    return [(i + k + offset) % n for i in range(streams)]


def run_dives(entry, judge_mod, traffic, seed, seconds, sync, vio, keep=True, trace=None):
    """Dives back to back until `seconds` have passed at a dive boundary.
    Returns (records per dive, the window's frame ms, the traced dive's
    frame ms, window s, the traced frames' live track-slot share). `trace` (a `Tracing`)
    profiles its frames of one more dive after the window, so that the
    window's frames are timed as in an untraced run."""
    import numpy as np
    import torch

    from dives import derive_seed

    S, T, n = int(traffic["streams"]), int(traffic["frames"]), len(traffic["scene_seeds"])
    offset = derive_seed(seed, 5) % n
    dives, frame_ms, traced_ms, live = [], [], [], []
    t0 = time.perf_counter()
    traced_k = -1             # the traced dive: one more after the window's
    k = 0
    while True:
        ids = dive_ids(k, S, n, offset)
        rng = np.random.RandomState(derive_seed(seed, 4, k))
        lo = min(8, T - 1)
        judged = set(int(f) for f in rng.choice(np.arange(lo, T), min(
            int(traffic["judged_frames_per_dive"]), T - lo), replace=False))
        st, frame = entry.start(ids)
        outs, snaps, pres = [], {}, {}
        for f in range(T):
            on = k == traced_k and trace.covers(f)
            if on:
                trace.before(f, st)
            if keep and f in judged:
                pres[f] = {p: field(st, p).clone() for p in judge_mod.PRE}
            t1 = time.perf_counter()
            st, out = frame(st, f)
            if keep:
                outs.append((out.state, out.Rcw, out.tcw, out.vio_ok if vio else None))
                if f in judged:
                    snaps[f] = {p: field(st, p).clone() for p in judge_mod.SNAP}
            if on:
                live.append(st.tracks.valid)
            sync()
            (traced_ms if k == traced_k else frame_ms).append((time.perf_counter() - t1) * 1e3)
            if on:
                trace.after(f)
        end = {p: field(st, p).clone() for p in judge_mod.END} if keep else None
        dives.append(dict(k=k, ids=ids, outs=outs, snaps=snaps, pres=pres, end=end))
        if k == traced_k:
            break
        k += 1
        if traced_k < 0 and time.perf_counter() - t0 >= seconds:
            window_s = time.perf_counter() - t0
            if trace is None:
                break
            traced_k = k
    live_share = (float(torch.stack([v.float().mean() for v in live]).mean())
                  if live else None)
    return dives, frame_ms, traced_ms, window_s, live_share


def host_records(dives, made, streams: int, vio: bool):
    """The window's records stream by stream on the host, for the judge:
    per (dive, stream) the frames' states, poses and VIO flags, the
    judged frames' snapshots after them and before them, and the dive's
    end."""
    import numpy as np
    import torch

    def np_(t):
        return t.detach().cpu().numpy()

    recs = []
    for d in dives:
        if not d["outs"]:
            continue
        cols = list(zip(*d["outs"]))
        state, Rcw, tcw = (np_(torch.stack(c)) for c in cols[:3])
        vflag = np_(torch.stack(cols[3])) if vio else None
        snaps = {f: {p: np_(t) for p, t in s.items()} for f, s in d["snaps"].items()}
        pres = {f: {p: np_(t) for p, t in s.items()} for f, s in d["pres"].items()}
        end = {p: np_(t) for p, t in d["end"].items()}
        for i, dive_ix in enumerate(d["ids"]):
            def pick(a):
                return a if streams == 1 else a[i]

            dive = made[dive_ix]
            recs.append(dict(
                dive=dive, k=d["k"], stream=i,
                state=state if streams == 1 else state[:, i],
                Rcw=Rcw if streams == 1 else Rcw[:, i], tcw=tcw if streams == 1 else tcw[:, i],
                vio=None if vflag is None else (vflag if streams == 1 else vflag[:, i]),
                snaps=[{p: pick(a) for p, a in s.items()} for _, s in sorted(snaps.items())],
                pres=[{p: pick(a) for p, a in s.items()} for _, s in sorted(pres.items())],
                end={p: pick(a) for p, a in end.items()},
                image=lambda f, dv=dive: dv.images[f].double().cpu().numpy()))
    return recs


def finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else str(v)


def run_cell(conf, traffic, seeds, seconds, trace=False, device=None, metrics=(), sink=None,
             on_entry=None):
    """One set-up, then one window per seed. Returns the result of the
    last seed (a dict, the printed line's) and prints nothing to stdout
    unless `sink` (called with each seed's calibration line) prints. The
    dives are the traffic's, made once; a seed orders them. `device`
    (default the first CUDA device) lets the tests run on the CPU;
    `on_entry(entry)` sees the program's entry before the dives start."""
    import numpy as np
    import torch

    import dives as dv

    cuda = device is None or torch.device(device).type == "cuda"
    device = torch.device("cuda", 0) if device is None else torch.device(device)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    entry_mod = importlib.import_module("entries." + conf["entry"])
    judge_mod = importlib.import_module("references." + conf["reference"])
    S, T = int(traffic["streams"]), int(traffic["frames"])
    entry = entry_mod.Entry(conf, S, dv.intrinsics(conf["sequence"]["H"],
                                                   conf["sequence"]["W"]), device)
    if on_entry is not None:
        on_entry(entry)
    sync()
    note(f"program and step loaded at {time.perf_counter() - T0:.2f} s")
    t_make = time.perf_counter()
    made = dv.make_dives(conf["sequence"], traffic["scene_seeds"], T, device)
    entry.load(made)
    sync()
    note(f"{len(made)} dives of {T} frames made and uploaded in "
         f"{time.perf_counter() - t_make:.2f} s")
    result = None
    for n_seed, seed in enumerate(seeds):
        if n_seed == 0:
            t_warm = time.perf_counter()
            run_dives(entry, judge_mod, traffic, seed, 0.0, sync, entry_mod.VIO, keep=False)
            note(f"warm-up dive {time.perf_counter() - t_warm:.2f} s, "
                 f"{entry.segments.captures} captures")
            gc.collect()
            gc.freeze()
            if cuda:
                torch.cuda.synchronize()
        setup_s = time.perf_counter() - T0
        syncs0, cap0 = entry.host_syncs(), entry.segments.captures
        tracing = Tracing(*traffic.get("traced_frames", [0, T])) if trace else None
        dives, frame_ms, traced_ms, window_s, live_share = run_dives(
            entry, judge_mod, traffic, seed, seconds, sync, entry_mod.VIO, trace=tracing)
        step_calls = len(frame_ms) + len(traced_ms)
        same_s = traced_s = None
        if tracing is not None:
            # the traced frames' host time, and the same frames' in the window's dives
            per_dive = np.asarray(frame_ms).reshape(-1, T)
            same_s = float(per_dive[:, tracing.a0:tracing.a1].sum(1).mean()) / 1e3
            traced_s = float(np.sum(traced_ms[tracing.a0:tracing.a1])) / 1e3
        syncs, captures = entry.host_syncs() - syncs0, entry.segments.captures - cap0
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        bad = forbidden_modules()
        if bad:
            note(f"modules loaded that the port must not load: {', '.join(bad)}")
            raise SystemExit(4)
        tr = None
        if tracing is not None:
            t_read = time.perf_counter()
            tr = tracing.read()
            note(f"traced frames {tracing.a0}-{tracing.a1 - 1}: {traced_s:.4f} s of the host "
                 f"clock under the device-only profiler ({tracing.window_s:.4f} s span), the "
                 f"same frames {same_s:.4f} s untraced (mean over {len(frame_ms) // T} dives); "
                 f"device busy {tr.busy_ns / 1e9:.4f} s")
            note(f"trace read in {time.perf_counter() - t_read:.1f} s: {tr.kernels} kernels, "
                 f"{tr.launches} launch calls, {len(tr.device)} device operations; "
                 f"{len(tracing.hand)} hand-kernel launches with their shapes: " + ", ".join(
                     sorted({f"{n.split('(')[0][-40:]} grid {a.get('grid')} block "
                             f"{a.get('block')} smem {a.get('shared memory')}"
                             for n, _, a in tracing.hand})))
        recs = host_records(dives, made, S, entry_mod.VIO)
        if n_seed == len(seeds) - 1:
            del entry
            gc.collect()
        t_judge = time.perf_counter()
        checks = judge_mod.judge(recs, conf["limits"])
        # the control only where asked for (a run of the benchmark judges
        # the program alone)
        ctrl = judge_mod.judge(recs, conf["limits"], tf32=True) if sink else None
        note(f"judged {len(recs)} stream-dives in {time.perf_counter() - t_judge:.2f} s")
        states = np.concatenate([r["state"] for r in recs]) if recs else np.zeros(0)
        run = types.SimpleNamespace(
            untraced_ms=frame_ms, window_s=window_s,
            stream_frames=len(frame_ms) * S, setup_s=setup_s,
            host_syncs=syncs, captures=captures, step_calls=step_calls, trace=tr,
            traced_calls=(tracing.a1 - tracing.a0) if tracing else 0, live_share=live_share,
            untraced_same_s=same_s, hand=tracing.hand if tracing else [],
            starts=[(xy.cpu().numpy(), v.cpu().numpy()) for xy, v in tracing.starts]
            if tracing else [], image_hw=(int(conf["sequence"]["H"]), int(conf["sequence"]["W"])),
            peak_bytes=peak, streams=S)
        shown = {}
        for m in metrics:
            v = metric_reader(m["name"])(run)
            if v is not None:
                shown[m["name"]] = {"value": float(v), "unit": m["unit"]}
        tails = [m["name"] for m in metrics if m["name"].startswith("frame_ms_p95")]
        note(f"window {window_s:.3f} s, {len(frame_ms)} step calls ({run.stream_frames} "
             f"stream-frames), {len(traced_ms)} more in the traced dive; "
             + "".join(f"{t} over {len(frame_ms)} frames (samples); " for t in tails)
             + f"setup {setup_s:.3f} s")
        correct = all(v <= lim for v, lim in checks.values())
        result = {"correct": bool(correct), "attempted": int(len(states)),
                  "failed": int(np.sum(states == LOST)), "metrics": shown,
                  "device": device_info(device, peak, tr, same_s)}
        if tr is not None:
            result["breakdown"] = {
                "device_ops": [[k[:64], v] for k, v in tr.top_ops[:10]],
                "idle_gaps": [[k, v] for k, v in tr.gaps[:10]]}
        result["checks"] = {k: {"value": finite(v), "limit": finite(lim)}
                            for k, (v, lim) in checks.items()}
        if sink is not None:
            sink(dict(seed=seed, correct=correct,
                      checks={k: finite(v) for k, (v, _) in checks.items()},
                      control={k: finite(v) for k, (v, _) in ctrl.items()},
                      control_correct=all(v <= lim for v, lim in ctrl.values()),
                      metrics={k: v["value"] for k, v in shown.items()},
                      dives=len(dives), window_s=window_s,
                      per_dive=[judge_mod.per_dive(r) for r in recs], frame_ms=frame_ms))
        for k, (v, lim) in checks.items():
            note(f"check {k}: {v!r} (limit {lim!r}){'' if v <= lim else ' FAILED'}")
    return result


class Tracing:
    """torch.profiler over frames a0..b1-1 of the traced dive (one after
    the window), in two parts:

    - frames a0..a1-1 with the device's activity alone (kernels, copies,
      fills and the runtime's launch calls; no host operations, whose
      recording slows the host about twice over): the busy time, the
      kernels, the launch calls and the top operations, read from the
      event list (`devtrace.summarize`) over the host clock's span of
      those frames;
    - frames a1..b1-1 with the host's activity too: the program's spans
      that name the longest idle gaps, and the trace file whose kernel
      records carry the hand kernels' launch shapes (`devtrace.launches`)."""

    NAMED = 4         # frames traced with the host's spans

    def __init__(self, a0: int, b1: int):
        self.a0, self.a1, self.b1 = a0, max(a0 + 1, b1 - self.NAMED), b1
        self.hand = []
        self.starts = []  # per named frame: the track positions and flags it starts from

    def covers(self, f: int) -> bool:
        return self.a0 <= f < self.b1

    def before(self, f: int, st):
        """Before frame f, from the state `st` that it starts from."""
        from torch.profiler import ProfilerActivity, profile, record_function

        if f >= self.a1:
            self.starts.append((st.tracks.xy.clone(), st.tracks.valid.clone()))
        if f == self.a0:
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        elif f == self.a1:
            self.named = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.named.__enter__()
            self.span = record_function("bench.traced")
            self.span.__enter__()

    def after(self, f: int):
        import devtrace

        if f == self.a1 - 1:
            self.window_s = time.perf_counter() - self.t0
            self.prof.__exit__(None, None, None)
        elif f == self.b1 - 1:
            self.span.__exit__(None, None, None)
            self.named.__exit__(None, None, None)
            self.hand = devtrace.launches(self.named, HAND_KERNELS)

    def read(self):
        """The device-only part's `Trace`, its gaps named from the part with
        the host's spans."""
        import devtrace

        tr = devtrace.summarize(self.prof, window_ns=self.window_s * 1e9)
        tr.gaps = devtrace.summarize(self.named).gaps
        return tr


HAND_KERNELS = ("extract_patches_kernel", "anchor_refine_kernel")


def device_info(device, peak, tr, same_s=None) -> dict:
    import torch

    if device.type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": int(peak)}
    if tr is not None:
        # the traced frames' length as the window runs them: the device-only
        # profile stretches the host's time between kernels, not the kernels
        info["busy_s"] = tr.busy_ns / 1e9
        info["window_s"] = same_s
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--seeds", help="comma-separated seeds: one window each, one set-up")
    args = ap.parse_args(argv)
    set_environment()
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    w, conf, traffic = find_cell(bench, args.workload)
    import torch

    chips = int(w["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        note(f"{args.workload} needs {chips} CUDA device(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    import uvipslam_torch

    if not os.path.abspath(uvipslam_torch.__file__).startswith(ROOT + os.sep):
        note(f"uvipslam_torch loads from {uvipslam_torch.__file__}, outside the checkout")
        return 3
    seeds = [int(s) for s in args.seeds.split(",")] if args.seeds else [args.seed]
    metrics = cell_metrics(bench, args.workload, bool(args.trace))

    def sink(line):
        print(json.dumps(line), flush=True)

    result = run_cell(conf, traffic, seeds, args.seconds, trace=bool(args.trace),
                      metrics=metrics, sink=sink if args.seeds else None)
    bad = forbidden_modules()
    if bad:
        note(f"modules loaded that the port must not load: {', '.join(bad)}")
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
