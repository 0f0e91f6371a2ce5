#!/usr/bin/env python3
"""Benchmark of the PyTorch + CUDA port (uvipslam_torch) on one NVIDIA GPU:
the counterpart of bench.py, with its sequences, configurations and gates.

    python bench_torch.py                     # the VIP line, then the mono line
    python bench_torch.py --mode vip          # one line (--mode mono likewise)
    python bench_torch.py --frames 40 --reps 1 --no-profile
    python bench_torch.py --eager             # the steps without CUDA graphs
    python bench_torch.py --device cpu        # the plain versions on the CPU

Prints ONE JSON line per mode on standard output (progress goes to
standard error):

  {"metric": ..., "value": fps, "unit": "fps", "vs_baseline": fps/20, "extra": {...}}

Baseline = bench.py's: the 20 fps camera rate. The fps value is gated on
tracking validity as bench.py gates it (VIP: VIO up, >= 80% of frames
WORKING, metric ATE over the WORKING frames from VIO init + 3 on, at
least 6 of them, below 5% of the span; mono: >= 80% WORKING, Sim3 ATE of
the WORKING frames below 2% of the span), and on the repeatability of the
measurement: every run gives the states and poses of the first timed run
bit for bit, the half run over its frames. When any fails, `value` and
`vs_baseline` are 0 and `extra.ok` is false.

Measurement mode: bench.py scans the whole sequence in one XLA program.
The port has no such program: the step runs frame by frame from the host
with a synchronize after each frame, so what is timed is the host clock of
a per-frame dispatched step (its streamed fps is its fps). On the card the
steps replay their WORKING frames' segments as captured CUDA graphs (the
steps' default, `utils/graphs.py`); `--eager` runs them op by op. Each run
starts from a fresh tracker, so it captures its graphs again, and the
captures are timed with it. The frame bundles are uploaded once. A run of the sequence's first N/2 frames goes
first: its first frame builds or loads the kernels (`first_frame_ms`, the
counterpart of bench.py's `compile_s`). Then `--reps` runs of all N
frames, each from a fresh tracker; fps is N over the median of their
clocks, as bench.py's is N over the median time of its whole scan, so
every frame counts: the first ones, the VIO-init frame and the keyframes'
window BA.

`extra` keys beyond bench.py's (`ok`, `frames_tracked`, `n_frames`; VIP
`vio_init_frame`, `ate_metric_m`; mono `ate_m`, `ate_threshold_m`):

- `wall_ms_per_frame` (the median run clock over N; fps = 1000 / it),
  `run_wall_ms` (each timed run's clock);
- `ms_per_frame`, the median of `run_medians_ms`, each a run's median
  ms/frame over frames 3 on without the VIO-init frame: the typical
  keyframe-free frame, beside the headline's mean over all frames;
- `first_frame_ms`, `vio_init_frame_ms` (VIP, the median over the timed
  runs of the VIO-init frame's ms);
- `runs_bitwise_equal`;
- `host_reads_per_frame`: the step's device-to-host reads of the first
  timed run (`step.host_syncs`) per frame; `compactions`: the landmark
  table's compactions in that run (`step.compactions`);
- `hand_kernel_launches_per_frame` (`ops.klt` counters of the first timed
  run) and `refine_wide_calls` (the wide refinement route; 0 on this path);
- `peak_allocated_mib`: `torch.cuda.max_memory_allocated` over the first
  timed run, the half run's step released before it (null on the CPU);
- `graphed` (whether the steps replayed captured graphs), `captures`,
  `replays_per_frame`, `capture_seconds` and `scan_steps` (the loop
  iterations replayed from graphs: the VIP step's VIO init's) of the
  first timed run (0 when eager);
- `plausibility`: whether the half run repeats the first N/2 frames bit
  for bit (a gate), and, as a statistic, the marginal ms/frame of the
  median timed run over the half run against the median ms/frame of its
  second half, and whether their ratio lies within [0.5, 2];
- `profile`: one more run under torch.profiler over one keyframe-free VI
  frame (VIP) or keyframe-free WORKING frame (mono): the host's launch
  calls (`host_launch_calls_per_frame`: kernel launches plus CUDA graph
  launches, the latter also alone) apart from the kernels the device ran
  (`device_kernels_per_frame`), `device_ms_per_frame`; null when
  skipped, on the CPU, or where the trace lacks its records;
- `device`: the card's name and power limit as nvidia-smi prints them
  ("cpu" on the CPU).

Without a card the script exits non-zero unless `--device cpu` is passed.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np

# bench.py's main_vip and main, keyword for keyword
VIP_SEQUENCE = dict(H=512, W=640, n_points=6000, seed=7, speed=1.2, gyr_noise=0.005,
                    acc_noise=0.05, gyr_bias=(0.004, -0.006, 0.003), depth_noise=0.02,
                    z_amp=0.5)
MONO_SEQUENCE = dict(H=512, W=640, n_points=6000, seed=7, speed=1.2)
VIP_CONFIG = dict(n_tracks=400, min_init_tracks=100, local_window=8, gyr_noise_sd=0.01,
                  acc_noise_sd=0.1, depth_noise_sd=0.05, vio_init_min_kfs=6,
                  vio_init_min_time=1.0)
MONO_CONFIG = dict(n_tracks=400, min_init_tracks=100, local_window=8)
CAPS = dict(kf_cap=64, pt_cap=8192)
VIP_FRAMES = 120
MONO_FRAMES = 60
REPS = 3
BASELINE_FPS = 20.0
# the profile frame is the first one from here on that the gates' run
# tracked WORKING (VIP: with VIO up) after a WORKING frame and that made
# no keyframe (chip_smoke.py's phases 9 and 7 profile from these frames)
PROFILE_FROM = {"vip": 30, "mono": 12}
PLAUSIBLE = (0.5, 2.0)    # band of the marginal ms/frame over the second half's median


def vip_gate(states, vio, centres, positions_w) -> dict:
    """bench.py:136-150 over numpy arrays of one run: states [N] int,
    vio [N] bool, camera centres [N, 3] and ground truth [N, 3]."""
    from uvipslam_torch.frontend.tracker import WORKING
    from uvipslam_torch.io.synthetic import ate_rmse

    states, vio = np.asarray(states), np.asarray(vio, bool)
    n = len(states)
    working = states == WORKING
    init_f = int(np.argmax(vio)) if vio.any() else -1
    sel = np.asarray([i for i in range(n) if init_f >= 0 and i >= init_f + 3 and working[i]],
                     dtype=np.int64)
    ate = -1.0
    if len(sel) > 5:
        ate, _ = ate_rmse(np.asarray(centres)[sel], np.asarray(positions_w)[sel],
                          align_scale=False)
    span = float(np.linalg.norm(positions_w[-1] - positions_w[0]))
    ok = bool(working.sum() >= 0.8 * n and 0.0 <= ate < 0.05 * span)
    return dict(ok=ok, frames_tracked=int(working.sum()), n_frames=n, vio_init_frame=init_f,
                ate_metric_m=float(ate), ate_threshold_m=0.05 * span, ate_frames=len(sel),
                span_m=span)


def mono_gate(states, centres, positions_w) -> dict:
    """bench.py:237-254 over numpy arrays of one run: states [N] int,
    camera centres [N, 3] and ground truth [N, 3]."""
    from uvipslam_torch.frontend.tracker import WORKING
    from uvipslam_torch.io.synthetic import ate_rmse

    states = np.asarray(states)
    n = len(states)
    working = states == WORKING
    ate = -1.0
    if working.sum() > 5:
        ate, _ = ate_rmse(np.asarray(centres)[working], np.asarray(positions_w)[working])
    span = float(np.linalg.norm(positions_w[-1] - positions_w[0]))
    ok = bool(working.sum() >= 0.8 * n and 0.0 <= ate < 0.02 * span)
    return dict(ok=ok, frames_tracked=int(working.sum()), n_frames=n, ate_m=float(ate),
                ate_threshold_m=0.02 * span, span_m=span)


def plausibility(frame_ms, wall_ms, half_frame_ms, half_wall_ms, init_frame=-1) -> dict:
    """Whether a run's clock adds up, as a statistic: the marginal cost of
    the frames an N-frame run has beyond an N/2-frame run of the same
    bundles, (T_N - T_N/2) over the frames between them, where T is a run's
    loop clock (`wall_ms`) less its first frame (the kernels' build in the
    half run) and the VIO-init frame (`init_frame`, -1 for none), and
    whether it lies within PLAUSIBLE times the median ms/frame of the
    N-frame run's frames N/2 on (the VIO-init frame left out). A clock
    that elides work (bench.py once published 0.78 ms for 120 frames) gives
    a marginal cost near 0."""
    n, h = len(frame_ms), len(half_frame_ms)

    def less(ms, wall):
        return wall - ms[0] - (ms[init_frame] if 0 < init_frame < len(ms) else 0.0)

    tail = [frame_ms[i] for i in range(h, n) if i != init_frame]
    marginal = (less(frame_ms, wall_ms) - less(half_frame_ms, half_wall_ms)) / max(1, len(tail))
    tail_med = statistics.median(tail) if tail else float("nan")
    ratio = marginal / tail_med if tail and tail_med > 0 else float("nan")
    return dict(within_band=bool(PLAUSIBLE[0] <= ratio <= PLAUSIBLE[1]),
                marginal_ms_per_frame=marginal, second_half_median_ms=tail_med, ratio=ratio)


def bench_line(metric: str, fps: float, ok: bool, extra: dict) -> dict:
    """bench.py's line: the value and its ratio to the baseline, 0 unless
    every gate and check passed."""
    return {"metric": metric, "value": fps if ok else 0.0, "unit": "fps",
            "vs_baseline": fps / BASELINE_FPS if ok else 0.0, "extra": {"ok": ok, **extra}}


def centres(Rs, ts):
    """Camera centres -R^T t [N, 3] float64 of a run's poses."""
    import torch

    R = torch.stack(Rs).double().cpu().numpy()
    t = torch.stack(ts).double().cpu().numpy()
    return -np.einsum("nji,nj->ni", R, t)


def note(*a):
    print("bench_torch:", *a, file=sys.stderr, flush=True)


def device_name(device) -> str:
    from uvipslam_torch.utils.chiptime import nvidia_smi_line

    return nvidia_smi_line() if device.type == "cuda" else "cpu"


def dispatch_form(extra) -> str:
    """How the line's steps dispatched their WORKING frames."""
    return "WORKING frames as CUDA graphs" if extra["graphed"] else "eager"


def profile_frame(mode, run) -> int | None:
    """The profile window's frame (see PROFILE_FROM), or None."""
    from uvipslam_torch.frontend.tracker import WORKING

    s, v, kf = run.states, run.vios, run.new_kf
    return next((f for f in range(PROFILE_FROM[mode], len(s))
                 if s[f - 1] == WORKING and s[f] == WORKING and kf[f] < 0
                 and (mode == "mono" or (v[f - 1] and v[f]))), None)


def profile_window(mode, new_tracker, feeds, run, device):
    """One more run up to the profile frame, then that frame under
    torch.profiler; None on the CPU, without such a frame, or where the
    trace lacks the records a profile reads."""
    from uvipslam_torch.utils import chiptime

    f = profile_frame(mode, run) if device.type == "cuda" else None
    if f is None:
        return None
    st, step = new_tracker()
    for x in feeds[:f]:
        st, _ = step(st, x)
    try:
        p = chiptime.profile_phase(step, st, feeds, f, 1, f"bench_profile_{mode}.txt",
                                   log=note)
    except chiptime.ProfileGap as e:
        note(f"{mode} profile: {e}")
        return None
    return dict(frame=f, host_launch_calls_per_frame=p["launches_per_frame"],
                graph_launches_per_frame=p["graph_launches_per_frame"],
                device_kernels_per_frame=p["device_kernels_per_frame"],
                device_ms_per_frame=p["device_ms_per_frame"],
                hand_kernels=p["hand_kernels"])


def measure(mode, new_tracker, feeds, reps, device, init_frame_of, profile=True) -> dict:
    """The runs of one mode: one of the sequence's first half (the kernels'
    build), `reps` runs of the whole sequence, then the profile window.
    Returns the first timed run, the runs' figures and checks (see the
    module docstring)."""
    import torch

    from uvipslam_torch.ops import klt
    from uvipslam_torch.utils import chiptime

    n = len(feeds)
    cuda = device.type == "cuda"
    # the half run's step (and on the card its graphs) is dropped before
    # the timed runs, so their peak memory is one step's
    half = chiptime.drive(new_tracker, feeds[:n // 2], device)._replace(step=None)
    note(f"{mode} half run ({n // 2} frames): first frame {half.frame_ms[0]:.1f} ms")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    klt.patch_launches = klt.refine_launches = klt.refine_wide_calls = 0
    runs = [chiptime.drive(new_tracker, feeds, device)]
    launches = {"extract_patches": klt.patch_launches, "anchor_refine": klt.refine_launches}
    wide = klt.refine_wide_calls
    peak = torch.cuda.max_memory_allocated() / 2 ** 20 if cuda else None
    syncs, compactions = runs[0].step.host_syncs, runs[0].step.compactions
    seg = runs[0].step.segments
    for r in range(1, reps):
        runs.append(chiptime.drive(new_tracker, feeds, device))
    equal = all(chiptime.same_run(r, runs[0]) for r in runs[1:])
    init_f = init_frame_of(runs[0])

    def median_ms(ms):
        return statistics.median([m for i, m in enumerate(ms) if i >= 2 and i != init_f])

    meds = [median_ms(r.frame_ms) for r in runs]
    walls = [r.wall_ms for r in runs]
    wall_ms_per_frame = statistics.median(walls) / n
    # the half run is held against the run whose clock is the headline's
    # (the middle one)
    mid = runs[sorted(range(len(runs)), key=lambda i: walls[i])[len(runs) // 2]]
    plaus = plausibility(mid.frame_ms, mid.wall_ms, half.frame_ms, half.wall_ms, init_f)
    plaus["half_run_frames"] = n // 2
    plaus["half_run_bitwise_equal"] = chiptime.same_run(half, runs[0], n // 2)
    note(f"{mode}: {wall_ms_per_frame:.2f} ms/frame over all frames (run clocks "
         f"{' / '.join(f'{w:.0f}' for w in walls)} ms), median frame "
         f"{statistics.median(meds):.2f} ms; marginal {plaus['marginal_ms_per_frame']:.2f} "
         f"ms/frame over the half run")
    ms_per_frame = statistics.median(meds)
    prof = profile_window(mode, new_tracker, feeds, runs[0], device) \
        if profile else None
    extra = dict(wall_ms_per_frame=wall_ms_per_frame, run_wall_ms=walls,
                 ms_per_frame=ms_per_frame, run_medians_ms=meds,
                 first_frame_ms=half.frame_ms[0], runs_bitwise_equal=equal,
                 host_reads_per_frame=syncs / n, compactions=compactions,
                 hand_kernel_launches_per_frame={k: v / n for k, v in launches.items()},
                 refine_wide_calls=wide, peak_allocated_mib=peak,
                 graphed=seg.enabled, captures=seg.captures, replays_per_frame=seg.replays / n,
                 capture_seconds=seg.capture_seconds, scan_steps=seg.scan_steps,
                 plausibility=plaus, profile=prof)
    if mode == "vip":
        extra["vio_init_frame_ms"] = (statistics.median(r.frame_ms[init_f] for r in runs)
                                      if init_f >= 0 else None)
    checks_ok = equal and plaus["half_run_bitwise_equal"]
    return dict(run=runs[0], extra=extra, checks_ok=checks_ok, fps=1000.0 / wall_ms_per_frame)


def run_vip(n_frames=VIP_FRAMES, reps=REPS, device="cuda", H=None, W=None,
            profile=True, graphs=None) -> dict:
    """bench.py --mode vip on the port: the line."""
    from uvipslam_torch.frontend.device_vip import build_vip_tracker, make_bundles
    from uvipslam_torch.frontend.tracker import step_device
    from uvipslam_torch.frontend.vip_tracker import VipConfig
    from uvipslam_torch.io.synthetic import make_sequence
    from uvipslam_torch.models.camera import CameraModel

    device = step_device(device)
    kw = {**VIP_SEQUENCE, "H": H or VIP_SEQUENCE["H"], "W": W or VIP_SEQUENCE["W"]}
    seq = make_sequence(n_frames=n_frames, **kw)
    cam = CameraModel.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2],
                             width=kw["W"], height=kw["H"])
    cfg = VipConfig(**VIP_CONFIG)
    feeds = make_bundles(seq, device=device)

    def new_tracker():
        return build_vip_tracker(cam, cfg, **CAPS, device=device, graphs=graphs)

    def init_frame_of(run):
        return int(np.argmax(run.vios)) if any(run.vios) else -1

    m = measure("vip", new_tracker, feeds, reps, device, init_frame_of, profile)
    run = m["run"]
    gate = vip_gate(run.states, run.vios, centres(run.Rs, run.ts), seq.positions_w)
    extra = {k: gate[k] for k in ("frames_tracked", "vio_init_frame", "n_frames",
                                  "ate_metric_m", "ate_threshold_m")}
    extra.update(m["extra"], device=device_name(device))
    where = "" if device.type == "cuda" else ", CPU: plain versions"
    metric = (f"PyTorch/CUDA port: VIP tracking+VI-BA fps ({kw['H']}x{kw['W']}, 400 feats, "
              f"IMU+pressure, per-frame dispatch, {dispatch_form(extra)}{where})")
    return bench_line(metric, m["fps"], gate["ok"] and m["checks_ok"], extra)


def run_mono(n_frames=MONO_FRAMES, reps=REPS, device="cuda", H=None, W=None,
             profile=True, graphs=None) -> dict:
    """bench.py's mono mode on the port: the line."""
    import torch

    from uvipslam_torch.frontend.device_tracker import build_tracker
    from uvipslam_torch.frontend.tracker import TrackerConfig, step_device
    from uvipslam_torch.io.synthetic import make_sequence
    from uvipslam_torch.models.camera import CameraModel

    device = step_device(device)
    kw = {**MONO_SEQUENCE, "H": H or MONO_SEQUENCE["H"], "W": W or MONO_SEQUENCE["W"]}
    seq = make_sequence(n_frames=n_frames, **kw)
    cam = CameraModel.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2],
                             width=kw["W"], height=kw["H"])
    cfg = TrackerConfig(**MONO_CONFIG)
    feeds = torch.from_numpy(seq.images.astype(np.float32)).to(device)

    def new_tracker():
        return build_tracker(cam, cfg, **CAPS, device=device, graphs=graphs)

    m = measure("mono", new_tracker, feeds, reps, device, lambda run: -1, profile)
    run = m["run"]
    gate = mono_gate(run.states, centres(run.Rs, run.ts), seq.positions_w)
    extra = {k: gate[k] for k in ("frames_tracked", "n_frames", "ate_m", "ate_threshold_m")}
    extra.update(m["extra"], device=device_name(device))
    where = "" if device.type == "cuda" else ", CPU: plain versions"
    metric = (f"PyTorch/CUDA port: mono tracking+local-BA fps ({kw['H']}x{kw['W']}, 400 feats, "
              f"synthetic Aqualoc-like, per-frame dispatch, {dispatch_form(extra)}{where})")
    return bench_line(metric, m["fps"], gate["ok"] and m["checks_ok"], extra)


def main(argv=None, H=None, W=None) -> int:
    """The command line; H and W replace the sequences' image size (the
    tests' small CPU runs)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("vip", "mono"),
                    help="one mode (default: the VIP line, then the mono line)")
    ap.add_argument("--frames", type=int,
                    help=f"frames per run (default: VIP {VIP_FRAMES}, mono {MONO_FRAMES})")
    ap.add_argument("--reps", type=int, default=REPS, help="timed runs per mode")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--no-profile", action="store_true",
                    help="skip the profile window")
    ap.add_argument("--eager", action="store_true",
                    help="run the steps op by op, without CUDA graphs (the default on the "
                         "card replays their WORKING frames and the VIO init's loops as "
                         "graphs)")
    args = ap.parse_args(argv)
    if args.reps < 1 or (args.frames is not None and args.frames < 4):
        ap.error("--reps must be >= 1 and --frames >= 4")
    import torch

    import uvipslam_torch  # noqa: F401  (turns TF32 off)

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("bench_torch.py: no CUDA device; it measures the port on a GPU "
              "(pass --device cpu for a run of the plain versions on the CPU)",
              file=sys.stderr)
        return 1
    kw = dict(reps=args.reps, device=args.device, H=H, W=W, profile=not args.no_profile,
              graphs=False if args.eager else None)
    if args.mode in (None, "vip"):
        print(json.dumps(run_vip(args.frames or VIP_FRAMES, **kw)), flush=True)
    if args.mode in (None, "mono"):
        print(json.dumps(run_mono(args.frames or MONO_FRAMES, **kw)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
