#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (uvipslam_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases (each passes or raises; any failure exits non-zero and prints no
result):
  1. require a CUDA device; print the card's name and power limit;
  2. build the hand-written kernels from uvipslam_torch/csrc (one nvcc
     per source, sm_90a) and print the build time and ptxas's registers
     and spills;
  3. hold each kernel against its plain torch version on the card:
     extract_patches at the main path's shapes (512x640, 256x320 and the
     ORB levels; psize 19/25/27/35; N = 400 or the level quota; border,
     outside and non-finite points), exact equality of patches and
     `local`; anchor_refine at the two settings of `propagate_tracks`
     (256x320 psize 27, 10 iterations; 512x640 psize 25, 8 iterations;
     N 400, real templates on a sub-pixel shifted image, the same probe
     points, some tracks invalid), within the tolerances of
     `refine_phase`. Median times as called, alone and of the plain
     versions over 20 runs (CUDA events), and each kernel's bound;
  4. small-input agreement: the first frame of a 120x160 sequence through
     the step on the card and on the CPU (plain versions) gives the same
     tracks;
  5. the mono device step at the reference's working point (512x640,
     400 tracks, kf_cap 64, pt_cap 8192, 60 frames; bench.py's settings)
     with the kernel launch counters reset just before: >= 80% of frames
     WORKING, Sim3-aligned ATE < 2% of the trajectory span, no LOST
     frame, and exactly the launches of each kernel the path's branches
     imply.
     Two more runs of the same sequence repeat the timing (the step is
     host-bound and its ms/frame spreads between runs of one process) and
     must give the same states and poses bit for bit;
  6. a replay of the first frames under torch.cuda sync-debug mode counts
     every host synchronization the step really makes;
  7. torch.profiler over a few WORKING frames: device time per frame,
     kernels and launches per frame, host and device time per phase of the
     step (its `step.*` spans, `step.propagate` on a line of its own),
     the hand kernels' device time per launch, the top operators (the
     full table goes to profile.txt in the output directory);
  8. mono relocalization: the mono step on the same sequence, then three
     black frames (the state must be LOST), then the last keyframe's image
     again: WORKING within three frames with the camera centre within 0.15
     of that keyframe's centre, and exactly the launches of each kernel
     its branches imply;
  9. the VIP step (IMU preintegration, pressure-scale VIO init, the VI
     solves and window BA) at bench.py's VIP settings (512x640, 400
     tracks, 120 frames, kf_cap 64, pt_cap 8192), three runs that must be
     bitwise equal: VIO initializes, >= 80% of frames WORKING, metric ATE
     (no scale alignment) over the WORKING frames from VIO init + 3 on
     below 5% of the trajectory span; the VIO-init frame's own ms, host
     reads, kernel launches, peak memory, a sync audit over the first 30
     frames and a profile split by phase over six VI frames after VIO
     init (table in chiprun_out/profile_vip.txt).

The last three lines of standard output are the steps' JSON record, the
per-kernel JSON record (launches per path, times, errors, bounds) and
{"ok": true, "device": {...}}. The script imports neither jax nor the reference package
uvipslam_tpu.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 60
REPEATS = 2      # timing repeats of each step after the gated run
BATCH = 50
VIP_FRAMES = 120
VIP_AUDIT_FRAMES = 30
RELOC_WARMUP = 30     # mono frames before the blackout


T0 = time.perf_counter()
MARKS = {}      # phase -> seconds since start at its end


def log(*a):
    print(*a, flush=True)


def mark(phase):
    MARKS[phase] = round(time.perf_counter() - T0, 1)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def probe_points(torch, h, w, n, seed):
    """n points: mostly inside, plus border, outside and non-finite ones
    (the first N_SPECIAL; from index 4 on they lie outside the image or
    are not finite)."""
    g = torch.Generator().manual_seed(seed)
    pts = torch.rand((n, 2), generator=g) * torch.tensor([w, h])
    special = torch.tensor([[0.0, 0.0], [w - 1e-3, h - 1e-3], [0.4, h / 2], [w - 0.2, 3.0],
                            [-7.5, 20.0], [w + 30.0, 9.0], [15.0, -1e9], [3.0, h + 0.5],
                            [-1e12, 40.0], [40.0, 1e12],
                            [float("nan"), 4.0], [float("inf"), 5.0], [6.0, float("-inf")]])
    k = min(len(special), n)
    pts[:k] = special[:k]
    return pts.contiguous()


N_SPECIAL = 13
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, published
F32_FLOPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores, published


def time_ms(torch, fn, reps=20):
    """Median of `reps` CUDA-event timings of fn() (after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the float32 rate."""
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def window_pixels(torch, tklt, img, pts, psize, sel=None):
    """Distinct image pixels under the patches at pts (rows `sel`): what
    a patch pull must read of the image."""
    h, w = img.shape
    x0, y0, _ = tklt.patch_corners(pts, h, w, psize)
    if sel is not None:
        x0, y0 = x0[sel], y0[sel]
    d = torch.arange(psize, device=img.device)
    idx = (y0.long()[:, None, None] + d[None, :, None]) * w + x0.long()[:, None, None] + d
    mask = torch.zeros(h * w, dtype=torch.bool, device=img.device)
    mask[idx.reshape(-1)] = True
    return int(mask.sum())


def patch_phase(torch, tklt, dev):
    """extract_patches vs its plain gather at the main path's shapes:
    exact equality of patches and `local`. Returns (max_abs_err, per-shape
    timing rows)."""
    from uvipslam_torch.ops.orb import level_quotas

    shapes = [((512, 640), 25, 400), ((512, 640), 19, 400), ((512, 640), 35, 400),
              ((256, 320), 27, 400), ((256, 320), 19, 400)]
    quotas = level_quotas(400, 8, 1.2)
    for l in range(1, 8):
        s = 1.2 ** l
        shapes.append(((int(round(512 / s)), int(round(640 / s))), 35, quotas[l]))
    max_err = 0.0
    rows = []
    g = torch.Generator(device=dev).manual_seed(0)
    for i, ((h, w), psize, n) in enumerate(shapes):
        img = torch.rand((h, w), generator=g, device=dev) * 255.0
        pts = probe_points(torch, h, w, n, seed=i).to(dev)
        kern, lk = tklt.extract_patches_cuda(img, pts, psize)
        plain, lp = tklt._extract_patches(img, pts, psize)
        torch.cuda.synchronize()
        if not torch.equal(kern, plain):
            raise AssertionError(f"kernel != plain at {h}x{w} psize {psize}: max "
                                 f"{(kern - plain).abs().max().item()}")
        if not torch.equal(torch.nan_to_num(lk, 7.0, 8.0, 9.0), torch.nan_to_num(lp, 7.0, 8.0, 9.0)):
            raise AssertionError(f"local differs at {h}x{w} psize {psize}")
        max_err = max(max_err, (kern - plain).abs().max().item())
        if i < 5 or psize == 35 and (h, w) == (427, 533):
            # as the path calls them: one launch / corners in torch + gather
            ms = time_ms(torch, lambda: tklt.extract_patches_cuda(img, pts, psize))
            pms = time_ms(torch, lambda: tklt._extract_patches(img, pts, psize))
            # alone: the kernel into preallocated outputs, and the plain
            # gather from precomputed indices, BATCH calls back to back
            out = torch.empty((n, psize, psize), device=dev)
            local = torch.empty((n, 2), device=dev)
            x0, y0, _ = tklt.patch_corners(pts, h, w, psize)
            d = torch.arange(psize, device=dev)
            ri = y0.long()[:, None, None] + d[None, :, None]
            ci = x0.long()[:, None, None] + d[None, None, :]

            def kern_only():
                for _ in range(BATCH):
                    tklt.launch_extract_patches(img, pts, psize, out, local)

            def plain_only():
                for _ in range(BATCH):
                    img[ri, ci]

            kms = time_ms(torch, kern_only) / BATCH
            kpms = time_ms(torch, plain_only) / BATCH
            nbytes = 4 * window_pixels(torch, tklt, img, pts, psize) + 4 * n * psize * psize + 16 * n
            bms, by = bound(nbytes, 0)
            rows.append(dict(shape=[h, w], psize=psize, n=n, ms=ms, plain_ms=pms,
                             alone_ms=kms, plain_gather_alone_ms=kpms, bytes=nbytes,
                             bound_ms=bms, bound_by=by))
            log(f"  extract_patches {h}x{w} psize {psize} N {n}: exact; as called kernel "
                f"{ms:.4f} ms vs plain {pms:.4f} ms; alone kernel {kms:.4f} ms vs plain gather "
                f"{kpms:.4f} ms (medians of 20 runs, CUDA events); bound {bms * 1e3:.3f} us "
                f"({nbytes} B)")
        else:
            log(f"  extract_patches {h}x{w} psize {psize} N {n}: exact")
    return max_err, rows


def wave_image(torch, h, w, dev, sx=0.0, sy=0.0):
    """A smooth textured image shifted by (sx, sy) pixels."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=dev) - sy,
                            torch.arange(w, dtype=torch.float64, device=dev) - sx,
                            indexing="ij")
    v = (128 + 40 * torch.sin(0.21 * xs + 0.13 * ys) + 30 * torch.cos(0.17 * ys - 0.11 * xs)
         + 20 * torch.sin(0.091 * xs + 0.29 * ys) + 15 * torch.cos(0.31 * xs - 0.05 * ys))
    return v.float().contiguous()


def refine_phase(torch, tklt, dev):
    """anchor_refine vs `_anchor_refine_plain` on the card at the two
    main-path settings, N 400: birth templates from extract_templates_fast
    on a smooth image, refined on the image shifted by (0.7, -0.4) px from
    the probe points, 5% of them marked invalid. Tolerances: accept equal
    except where the plain version lies within 1e-3 of a threshold; out
    within 1e-3 px where both accept; the outside and non-finite probe
    points rejected with out = pts (NaN for NaN); >= 90% of the valid
    interior tracks accepted. Returns (max_abs_err, timing rows)."""
    settings = [((256, 320), 10, 5.0, 45.0), ((512, 640), 8, 4.0, 32.0)]
    rows, max_err = [], 0.0
    win, n = 13, 400
    for i, ((h, w), iters, mc, mr) in enumerate(settings):
        a = wave_image(torch, h, w, dev)
        b = wave_image(torch, h, w, dev, 0.7, -0.4)
        pts = probe_points(torch, h, w, n, seed=20 + i).to(dev)
        T, Tx, Ty = tklt.extract_templates_fast(a, torch.nan_to_num(pts), win)
        valid = (torch.rand(n, generator=torch.Generator().manual_seed(i)) > 0.05).to(dev)
        args = (b, T, Tx, Ty, pts, valid)
        kw = dict(win=win, iters=iters, max_correction=mc, max_residual=mr)
        out, acc = tklt.anchor_refine_cuda(*args, **kw)
        p_out, p_acc = tklt._anchor_refine_plain(*args, **kw)
        _, _, good, resid, corr = tklt._refine_terms(b, T, Tx, Ty, pts, win, iters, mc)
        torch.cuda.synchronize()
        near = ((corr - mc).abs() < 1e-3) | ((resid - mr).abs() < 1e-3)
        flips = int(((acc != p_acc) & ~near).sum())
        both = acc & p_acc
        err = (out[both] - p_out[both]).abs().max().item() if bool(both.any()) else 0.0
        sp = slice(4, N_SPECIAL)
        edge_ok = (not bool(acc[sp].any()) and not bool(p_acc[sp].any()) and torch.equal(
            torch.nan_to_num(out[sp], 7.0, 8.0, 9.0), torch.nan_to_num(pts[sp], 7.0, 8.0, 9.0)))
        inner = valid.clone()
        inner[:N_SPECIAL] = False
        share = int((acc & inner).sum()) / int(inner.sum())
        psize = tklt.refine_psize(win, mc)
        log(f"  anchor_refine {h}x{w} psize {psize} iters {iters} N {n}: accept flips outside "
            f"the 1e-3 margins {flips} (inside {int(((acc != p_acc) & near).sum())}), max |out "
            f"- plain| where both accept {err:.3e} px over {int(both.sum())} tracks, outside and "
            f"non-finite points {'rejected with out = pts' if edge_ok else 'WRONG'}, valid "
            f"interior accepted {100 * share:.1f}%")
        if flips or not err <= 1e-3 or not edge_ok or share < 0.9:
            raise AssertionError(f"anchor_refine kernel disagrees at {h}x{w}")
        max_err = max(max_err, err)

        ms = time_ms(torch, lambda: tklt.anchor_refine_cuda(*args, **kw))
        pms = time_ms(torch, lambda: tklt._anchor_refine_plain(*args, **kw))
        o2 = torch.empty_like(out)
        a2 = torch.empty_like(acc)

        def kern_only():
            for _ in range(BATCH):
                tklt.launch_anchor_refine(*args, win, iters, mc, mr, o2, a2)

        kms = time_ms(torch, kern_only) / BATCH
        # what this run's data needs: templates of the valid tracks with a
        # finite start, the image under the patches of those with good_G;
        # per template pixel 6 flops for G, 14 per iteration, 12 for the
        # residual
        _, _, local = tklt.patch_corners(pts, h, w, psize)
        work = valid & torch.isfinite(local).all(-1)
        n_work, n_good = int(work.sum()), int((work & good).sum())
        nbytes = (3 * 4 * win * win * n_work + 4 * window_pixels(torch, tklt, b, pts, psize,
                                                                 work & good)
                  + n * (8 + 1 + 8 + 1))
        flops = win * win * (6 * n_work + (14 * iters + 12) * n_good)
        bms, by = bound(nbytes, flops)
        rows.append(dict(shape=[h, w], psize=psize, iters=iters, n=n, ms=ms, plain_ms=pms,
                         alone_ms=kms, bytes=nbytes, flops=flops, bound_ms=bms, bound_by=by,
                         max_abs_err=err))
        log(f"    as called kernel {ms:.4f} ms vs plain {pms:.4f} ms; alone kernel {kms:.4f} ms "
            f"(medians of 20 runs, CUDA events); bound {bms * 1e3:.3f} us by {by} ({nbytes} B, "
            f"{flops} flop)")
    return max_err, rows


def drive(torch, new_tracker, feeds):
    """A fresh tracker from `new_tracker()` passed once over the sequence's
    per-frame inputs: the step, per-frame states, poses, VIO flags (VIP)
    and ms (host clock around a step that ends in a synchronize). No
    reference to the initial state outlives its first frame, so peak
    memory is the step's own."""
    st, step = new_tracker()
    states, Rs, ts, vios, frame_ms = [], [], [], [], []
    for x in feeds:
        t1 = time.perf_counter()
        st, out = step(st, x)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t1) * 1e3)
        states.append(int(out.state))
        vios.append(bool(getattr(out, "vio_ok", False)))
        Rs.append(out.Rcw)
        ts.append(out.tcw)
    return step, states, Rs, ts, vios, frame_ms


def timed_runs(torch, new_tracker, feeds, first):
    """REPEATS more runs after `first` (a drive() result); each must give
    the same states and poses bit for bit. Returns the run medians of the
    per-frame ms over frames 3 on."""
    _, states, Rs, ts, _, frame_ms = first
    meds = [statistics.median(frame_ms[2:])]
    for _ in range(REPEATS):
        _, states_r, Rs_r, ts_r, _, ms_r = drive(torch, new_tracker, feeds)
        meds.append(statistics.median(ms_r[2:]))
        if states_r != states or not all(
                torch.equal(a, b) for a, b in zip(Rs_r + ts_r, Rs + ts)):
            raise AssertionError("a repeat run of the step differs from the main run")
    return meds


def centres(torch, np, Rs, ts):
    R = torch.stack(Rs).double().cpu().numpy()
    t = torch.stack(ts).double().cpu().numpy()
    if not (np.isfinite(R).all() and np.isfinite(t).all()):
        raise AssertionError("non-finite pose")
    return -np.einsum("nji,nj->ni", R, t)


def expected_launches(states, n_orb_levels, prev=None):
    """Launches of each kernel implied by the branch each frame of the
    mono step ran (the state a frame starts in is the previous frame's
    output state, NOT_INITIALIZED before the first): a propagate is two
    anchor refinements, a refill two template pulls and one per ORB
    level, a refresh one pull; LOST runs a fresh detection (refill +
    refresh)."""
    from uvipslam_torch.frontend.tracker import INITIALIZING, LOST, NOT_INITIALIZED, WORKING

    refill = 2 + n_orb_levels
    pulls = refines = 0
    prev = NOT_INITIALIZED if prev is None else prev
    for s in states:
        if prev == NOT_INITIALIZED:
            pulls += refill
        elif prev == INITIALIZING:
            refines += 2
        elif prev == WORKING:
            refines += 2
            pulls += refill + 1 if s == WORKING else 0
        elif prev == LOST:
            pulls += refill + 1
        prev = s
    return {"extract_patches": pulls, "anchor_refine": refines}


def read_launches(tklt):
    return {"extract_patches": tklt.patch_launches, "anchor_refine": tklt.refine_launches}


def reset_launches(tklt):
    tklt.patch_launches = 0
    tklt.refine_launches = 0


def profile_phase(torch, step, st, feeds, start, n, out_name):
    """torch.profiler over frames start..start+n-1: device busy time and
    the top operators by device and by host time (full table to
    chiprun_out/<out_name>), host and device time per `step.*` span. Fails
    when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in range(start, start + n):
            st, _ = step(st, feeds[f])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3   # the profiler's teardown excluded
    ev = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    def dev_total_us(e):
        return getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))

    # device-side kernel events only (the operators that launched them
    # report the same time again; the spans' device-side twins are ranges)
    from torch.autograd import DeviceType

    gpu = [e for e in ev if e.device_type == DeviceType.CUDA and not e.key.startswith("step.")]
    # host time in each phase span, and the device time of the kernels it
    # launched
    spans = {e.key: dict(host_ms=e.cpu_time_total / 1e3 / n,
                         device_ms=dev_total_us(e) / 1e3 / n, calls=e.count / n)
             for e in ev if e.key.startswith("step.") and e.device_type == DeviceType.CPU}
    device_ms = sum(dev_us(e) for e in gpu) / 1e3
    kernels = sum(e.count for e in gpu)
    launches = sum(e.count for e in ev if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                    "cudaLaunchKernelExC"))
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", out_name), "w") as fh:
        fh.write(ev.table(sort_by="self_cuda_time_total", row_limit=60))
        fh.write("\n\n")
        fh.write(ev.table(sort_by="self_cpu_time_total", row_limit=40))
    if device_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    top_dev = sorted(gpu, key=dev_us, reverse=True)[:8]
    top_cpu = sorted(ev, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    log(f"  frames {start}-{start + n - 1} under torch.profiler, which slows the host: "
        f"wall {wall_ms / n:.1f} ms/frame, device busy {device_ms / n:.2f} ms/frame, "
        f"{kernels / n:.0f} device kernels and {launches / n:.0f} kernel launches/frame")
    log("  top device: " + "; ".join(f"{e.key[:60]} {dev_us(e) / 1e3 / n:.3f} ms x{e.count // n}"
                                     for e in top_dev))
    log("  top host: " + "; ".join(f"{e.key[:40]} {e.self_cpu_time_total / 1e3 / n:.2f} ms "
                                   f"x{e.count // n}" for e in top_cpu))
    log("  per phase (ms/frame, host under the profiler / device): " + "; ".join(
        f"{k[5:]} {v['host_ms']:.1f} / {v['device_ms']:.2f} (x{v['calls']:.2f})"
        for k, v in sorted(spans.items(), key=lambda kv: -kv[1]["host_ms"])))
    prop = spans.get("step.propagate")
    if prop is None:
        raise AssertionError("no step.propagate span in the profile window")
    log(f"  {launches / n:.0f} kernel launches per frame; step.propagate host {prop['host_ms']:.2f} "
        f"ms / device {prop['device_ms']:.3f} ms per frame")
    # the hand-written kernels' own device time per launch on the path
    ours = {name: [e for e in gpu if name in e.key] for name in
            ("extract_patches_kernel", "anchor_refine_kernel")}
    ours = {k: dict(launches=sum(e.count for e in v),
                    device_us_per_launch=sum(dev_us(e) for e in v) / max(1, sum(e.count for e in v)))
            for k, v in ours.items()}
    log("  hand kernels on the path: " + "; ".join(
        f"{k} {v['launches']} launches, {v['device_us_per_launch']:.2f} us device each"
        for k, v in ours.items()))
    return dict(wall_ms_per_frame_profiled=wall_ms / n, device_ms_per_frame=device_ms / n,
                device_kernels_per_frame=kernels / n, launches_per_frame=launches / n,
                phases=spans, hand_kernels=ours)


def sync_audit(torch, step, st, feeds, n):
    """Runs frames 0..n-1 under torch.cuda sync-debug mode. Returns (the
    synchronizing calls seen, by call site, the state after frame n-1)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for f in range(n):
                st, _ = step(st, feeds[f])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    real = [w for w in caught if "synchroniz" in str(w.message).lower()]
    where = {}
    for w in real:
        key = f"{os.path.basename(w.filename)}:{w.lineno}"
        where[key] = where.get(key, 0) + 1
    return real, where, st


def reloc_phase(torch, np, tklt, new_tracker, imgs):
    """The mono step WORKING on the sequence, three black frames (LOST),
    then the last keyframe's image again until WORKING (three frames at
    most). Returns (frames to recover, centre error, kernel launches from
    the first black frame on, the launches its branches imply, the
    keyframe's frame)."""
    from uvipslam_torch.frontend.tracker import LOST, WORKING

    st, step = new_tracker()
    for f in range(RELOC_WARMUP):
        st, out = step(st, imgs[f])
    if int(out.state) != WORKING:
        raise AssertionError(f"mono step not WORKING after {RELOC_WARMUP} frames")
    torch.cuda.synchronize()
    reset_launches(tklt)
    black = torch.zeros_like(imgs[0])
    states = []
    for _ in range(3):
        st, out = step(st, black)
        states.append(int(out.state))
    if states[-1] != LOST:
        raise AssertionError(f"state {states[-1]} after three black frames, not LOST")
    k = int(st.map.n_kf) - 1
    kf_frame = int(st.map.kf_frame_id[k])
    C_kf = st.map.kf_ns.p[k].double().cpu().numpy()
    for n in range(1, 4):
        st, out = step(st, imgs[kf_frame])
        states.append(int(out.state))
        if states[-1] == WORKING:
            break
    else:
        raise AssertionError("no relocalization within three frames")
    torch.cuda.synchronize()
    launches = read_launches(tklt)
    expect = expected_launches(states, 8, prev=WORKING)
    C = centres(torch, np, [out.Rcw], [out.tcw])[0]
    err = float(np.linalg.norm(C - C_kf))
    if not err < 0.15:
        raise AssertionError(f"relocalized centre {C} is {err} from keyframe centre {C_kf}")
    if launches != expect or min(launches.values()) <= 0:
        raise AssertionError(f"relocalization path launches {launches}, expected {expect}")
    return n, err, launches, expect, kf_frame


def orb_levels(h, w, n=8, scale=1.2):
    """The ORB pyramid levels `extract_orb` keeps at an image size."""
    while n > 1 and min(h, w) / scale ** (n - 1) < 40:
        n -= 1
    return n


def expected_launches_vip(states, n_orb_levels):
    """Launches of each kernel on the VIP step when no frame is LOST or
    in IMU recovery: the shared detection (template pulls, ORB levels and
    the descriptor refresh) runs in NOT_INITIALIZED and WORKING, the two
    anchor refinements in INITIALIZING and WORKING."""
    from uvipslam_torch.frontend.tracker import INITIALIZING, NOT_INITIALIZED, WORKING

    detect = 2 + n_orb_levels + 1
    pulls = refines = 0
    prev = NOT_INITIALIZED
    for s in states:
        pulls += detect if prev in (NOT_INITIALIZED, WORKING) else 0
        refines += 2 if prev in (INITIALIZING, WORKING) else 0
        prev = s
    return {"extract_patches": pulls, "anchor_refine": refines}


def vip_phase(torch, np, tklt, dev, smi):
    """Phase 9. Returns (the step record, launches on the VIP path)."""
    from uvipslam_torch.frontend.device_vip import build_vip_tracker, make_bundles
    from uvipslam_torch.frontend.tracker import IMU_RELOC, LOST, WORKING
    from uvipslam_torch.frontend.vip_tracker import VipConfig
    from uvipslam_torch.io.synthetic import ate_rmse, make_sequence
    from uvipslam_torch.models.camera import CameraModel

    t0 = time.time()
    seq = make_sequence(n_frames=VIP_FRAMES, H=512, W=640, n_points=6000, seed=7, speed=1.2,
                        gyr_noise=0.005, acc_noise=0.05, gyr_bias=(0.004, -0.006, 0.003),
                        depth_noise=0.02, z_amp=0.5)
    mark("vip_sequence")
    log(f"sequence {VIP_FRAMES}x512x640 with IMU and pressure generated in "
        f"{time.time() - t0:.1f} s")
    cam = CameraModel.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2],
                             width=640, height=512)
    cfg = VipConfig(n_tracks=400, min_init_tracks=100, local_window=8, gyr_noise_sd=0.01,
                    acc_noise_sd=0.1, depth_noise_sd=0.05, vio_init_min_kfs=6,
                    vio_init_min_time=1.0)
    bundles = make_bundles(seq, device=dev)     # the whole sequence uploaded once

    def new_tracker():
        return build_vip_tracker(cam, cfg, kf_cap=64, pt_cap=8192, device=dev)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(tklt)
    first = drive(torch, new_tracker, bundles)
    launches = read_launches(tklt)
    step, states, Rs, ts, vios, frame_ms = first
    syncs = step.host_syncs
    peak = torch.cuda.max_memory_allocated()
    run_meds = timed_runs(torch, new_tracker, bundles, first)
    med = statistics.median(run_meds)

    states = np.asarray(states)
    vios = np.asarray(vios)
    working = states == WORKING
    C = centres(torch, np, Rs, ts)
    span = float(np.linalg.norm(seq.positions_w[-1] - seq.positions_w[0]))
    init_f = int(np.argmax(vios)) if vios.any() else -1
    sel = np.asarray([i for i in range(VIP_FRAMES) if init_f >= 0 and i >= init_f + 3
                      and working[i]], dtype=np.int64)
    ate = float("inf")
    if len(sel) > 5:
        ate, _ = ate_rmse(C[sel], seq.positions_w[sel], align_scale=False)
    n_levels = orb_levels(*seq.images.shape[1:])
    clean = not ((states == LOST) | (states == IMU_RELOC)).any()
    expect = expected_launches_vip(states.tolist(), n_levels) if clean else None
    init_ms = frame_ms[init_f] if init_f >= 0 else float("nan")
    log(f"phase VIP step 512x640 / 400 tracks / {VIP_FRAMES} frames: VIO init at frame "
        f"{init_f}, {int(working.sum())}/{VIP_FRAMES} WORKING, {int((states == LOST).sum())} "
        f"LOST, {int((states == IMU_RELOC).sum())} IMU_RELOC, metric ATE {ate:.5f} m over "
        f"{len(sel)} frames (threshold {0.05 * span:.5f} m, 5% of span {span:.4f} m)")
    log(f"  median {med:.2f} ms/frame over {len(run_meds)} runs (host clock to synchronize, "
        f"frames 3-{VIP_FRAMES}; run medians {' / '.join(f'{m:.2f}' for m in run_meds)}; "
        f"states and poses bitwise equal across runs; first frame {frame_ms[0]:.1f} ms), "
        f"VIO-init frame {init_ms:.1f} ms, host reads {syncs / VIP_FRAMES:.2f}/frame "
        f"({syncs} total), kernel launches {launches}"
        f"{f' (expected {expect})' if expect is not None else ''}, "
        f"peak allocated {peak / 2**20:.1f} MiB")
    log(f"  states {''.join(str(s) for s in states.tolist())}")
    if init_f < 0:
        raise AssertionError("VIO never initialized")
    if working.sum() < 0.8 * VIP_FRAMES:
        raise AssertionError(f"only {int(working.sum())}/{VIP_FRAMES} frames WORKING")
    if not ate < 0.05 * span:
        raise AssertionError(f"metric ATE {ate} >= 5% of span {span}")
    if min(launches.values()) <= 0 or (expect is not None and launches != expect):
        raise AssertionError(f"kernel launches {launches}, expected {expect}")
    mark("vip_step")

    st_a, step_a = new_tracker()
    real, where, _ = sync_audit(torch, step_a, st_a, bundles, VIP_AUDIT_FRAMES)
    log(f"phase VIP sync audit ({VIP_AUDIT_FRAMES} frames): "
        f"{len(real) / VIP_AUDIT_FRAMES:.2f} synchronizing calls/frame seen by torch.cuda "
        f"sync-debug mode, {step_a.host_syncs / VIP_AUDIT_FRAMES:.2f}/frame counted by the step")
    log("  by call site: " + ", ".join(f"{k} x{v}" for k, v in sorted(
        where.items(), key=lambda kv: -kv[1])[:12]))

    mark("vip_audit")
    # the profile window: six VI frames after VIO init. The init frame
    # alone launches ~0.4M kernels, whose profiler events take minutes to
    # post-process; its own time is the timed run's VIO-init frame ms
    start = init_f + 1
    st_p, step_p = new_tracker()
    for f in range(start):
        st_p, _ = step_p(st_p, bundles[f])
    log("phase VIP profile:")
    profile = profile_phase(torch, step_p, st_p, bundles, start, 6, "profile_vip.txt")
    profile["device_idle_share"] = 1.0 - profile["device_ms_per_frame"] / med
    mark("vip_profile")
    log(f"  device busy {profile['device_ms_per_frame']:.2f} ms/frame in the window; idle "
        f"share against the unprofiled {med:.1f} ms/frame: "
        f"{100 * profile['device_idle_share']:.1f}%")
    record = {"frames_working": int(working.sum()), "n_frames": VIP_FRAMES,
              "vio_init_frame": init_f, "ate_metric_m": ate,
              "ate_threshold_m": 0.05 * span, "median_ms_per_frame": med,
              "run_medians_ms": run_meds, "vio_init_frame_ms": init_ms,
              "host_reads_per_frame": syncs / VIP_FRAMES,
              "sync_calls_per_frame_audit": len(real) / VIP_AUDIT_FRAMES,
              "peak_allocated_bytes": peak, "profile": profile, "card": smi}
    return record, launches


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "uvipslam_torch")):
        print("chip_smoke.py must run from a checkout holding uvipslam_torch/",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py measures the port on a GPU only",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    log("python", sys.version.split()[0], "torch", torch.__version__, "cuda", torch.version.cuda)
    smi = nvidia_smi_line()
    log(smi)

    import uvipslam_torch  # noqa: F401  (turns TF32 off)
    from uvipslam_torch import kernels
    from uvipslam_torch.ops import klt as tklt

    # -- phase 2: build ------------------------------------------------
    t0 = time.time()
    path = kernels.build()
    kernels.load()
    log(f"phase build: {os.path.basename(path)} in {time.time() - t0:.2f} s "
        f"(nvcc {kernels.build_seconds if kernels.build_seconds is not None else 0.0:.2f} s)")
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas: " + line.strip())
    mark("build")

    # -- phase 3: kernels vs plain ---------------------------------------
    log("phase kernel-vs-plain: extract_patches (exact equality)")
    patch_err, patch_rows = patch_phase(torch, tklt, dev)
    log("phase kernel-vs-plain: anchor_refine (1e-3 px where both accept)")
    refine_err, refine_rows = refine_phase(torch, tklt, dev)
    mark("kernel_vs_plain")

    # -- phase 4/5 need the synthetic sequences -------------------------
    from uvipslam_torch.frontend.device_tracker import build_tracker
    from uvipslam_torch.frontend.tracker import LOST, WORKING, TrackerConfig
    from uvipslam_torch.io.synthetic import ate_rmse, make_sequence
    from uvipslam_torch.models.camera import CameraModel

    small = make_sequence(n_frames=1, H=120, W=160, n_points=800, seed=3, speed=1.2)
    cam_s = CameraModel.create(small.K[0, 0], small.K[1, 1], small.K[0, 2], small.K[1, 2],
                               width=160, height=120)
    cfg_s = TrackerConfig(n_tracks=100, min_init_tracks=60, local_window=8)
    img0 = torch.from_numpy(small.images[0].astype(np.float32))
    tr = {}
    for d in ("cpu", "cuda"):
        st, step = build_tracker(cam_s, cfg_s, 16, 1024, device=d)
        st, _ = step(st, img0.to(d))
        tr[d] = st.tracks
    # detections on resized pyramid levels may flip where a float32 sum
    # lands on a FAST threshold, so the check is set-wise: >= 95% of the
    # card's tracks are CPU tracks at the same pixel with the same
    # descriptor and templates within 1e-3
    cpu = {tuple(p): i for i, p in enumerate(tr["cpu"].xy.numpy().tolist())}
    card_xy = tr["cuda"].xy.cpu().numpy().tolist()
    same, tpl_err = 0, 0.0
    for j, p in enumerate(card_xy):
        i = cpu.get(tuple(p))
        if i is None or not torch.equal(tr["cpu"].desc[i], tr["cuda"].desc[j].cpu()):
            continue
        same += 1
        tpl_err = max(tpl_err, (tr["cpu"].tpl[i] - tr["cuda"].tpl[j].cpu()).abs().max().item(),
                      (tr["cpu"].tpl2[i] - tr["cuda"].tpl2[j].cpu()).abs().max().item())
    if same < 0.95 * len(card_xy) or tpl_err > 1e-3:
        raise AssertionError(f"small-input frame 0: {same}/{len(card_xy)} tracks agree "
                             f"card vs CPU, templates within {tpl_err}")
    log(f"phase small-input agreement: {same}/{len(card_xy)} frame-0 tracks equal card "
        f"vs CPU (templates within {tpl_err:.2e})")

    t0 = time.time()
    seq = make_sequence(n_frames=N_FRAMES, H=512, W=640, n_points=6000, seed=7, speed=1.2)
    mark("sequence")
    log(f"sequence 60x512x640 generated in {time.time() - t0:.1f} s")
    cam = CameraModel.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2],
                             width=640, height=512)
    cfg = TrackerConfig(n_tracks=400, min_init_tracks=100, local_window=8)
    imgs = torch.from_numpy(seq.images.astype(np.float32)).to(dev)

    # -- phase 5: the mono step ------------------------------------------
    def new_tracker():
        return build_tracker(cam, cfg, kf_cap=64, pt_cap=8192, device=dev)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(tklt)
    first = drive(torch, new_tracker, imgs)
    launches = read_launches(tklt)
    step, states, Rs, ts, _, frame_ms = first
    syncs = step.host_syncs
    peak = torch.cuda.max_memory_allocated()
    run_meds = timed_runs(torch, new_tracker, imgs, first)

    states = np.asarray(states)
    working = states == WORKING
    C = centres(torch, np, Rs, ts)
    span = float(np.linalg.norm(seq.positions_w[-1] - seq.positions_w[0]))
    ate = float("inf")
    if working.sum() > 5:
        ate, _ = ate_rmse(C[working], seq.positions_w[np.nonzero(working)[0]])
    n_levels = 8
    expect = expected_launches(states.tolist(), n_levels)
    med = statistics.median(run_meds)
    log(f"phase mono step 512x640 / 400 tracks: {int(working.sum())}/{N_FRAMES} WORKING, "
        f"{int((states == LOST).sum())} LOST, ATE {ate:.5f} m (threshold {0.02 * span:.5f} m, "
        f"2% of span {span:.4f} m)")
    log(f"  median {med:.2f} ms/frame over {len(run_meds)} runs (host clock to synchronize, "
        f"frames 3-60; run medians {' / '.join(f'{m:.2f}' for m in run_meds)}; states and "
        f"poses bitwise equal across runs; first frame {frame_ms[0]:.1f} ms), "
        f"host reads {syncs / N_FRAMES:.2f}/frame "
        f"({syncs} total), kernel launches {launches} (expected {expect}), "
        f"peak allocated {peak / 2**20:.1f} MiB")
    log(f"  states {''.join(str(s) for s in states.tolist())}")
    if working.sum() < 0.8 * N_FRAMES:
        raise AssertionError(f"only {int(working.sum())}/{N_FRAMES} frames WORKING")
    if not ate < 0.02 * span:
        raise AssertionError(f"ATE {ate} >= 2% of span {span}")
    if (states == LOST).any():
        raise AssertionError("LOST frames")
    if min(launches.values()) <= 0 or launches != expect:
        raise AssertionError(f"kernel launches {launches}, expected {expect}")
    mark("mono_step")

    # -- phase 6: sync audit ----------------------------------------------
    audit_frames = 12
    st_a, step_a = new_tracker()
    real, where, st_a = sync_audit(torch, step_a, st_a, imgs, audit_frames)
    log(f"phase sync audit ({audit_frames} frames): {len(real) / audit_frames:.2f} "
        f"synchronizing calls/frame seen by torch.cuda sync-debug mode, "
        f"{step_a.host_syncs / audit_frames:.2f}/frame counted by the step")
    log("  by call site: " + ", ".join(f"{k} x{v}" for k, v in sorted(
        where.items(), key=lambda kv: -kv[1])[:12]))

    # -- phase 7: profile ---------------------------------------------------
    mark("mono_audit")
    log("phase profile:")
    profile = profile_phase(torch, step_a, st_a, imgs, audit_frames, 6, "profile.txt")
    mark("mono_profile")
    # device time does not depend on the profiler; the host clock does
    profile["device_idle_share"] = 1.0 - profile["device_ms_per_frame"] / med
    log(f"  device idle share at the unprofiled {med:.1f} ms/frame: "
        f"{100 * profile['device_idle_share']:.1f}%")

    # -- phase 8: mono relocalization ----------------------------------------
    n_rec, rec_err, reloc_launches, reloc_expect, kf_frame = reloc_phase(torch, np, tklt,
                                                                         new_tracker, imgs)
    mark("mono_reloc")
    log(f"phase mono relocalization: LOST after 3 black frames; WORKING again on the "
        f"{n_rec}. frame of keyframe {kf_frame}'s image, camera centre {rec_err:.4f} from the "
        f"keyframe's (bound 0.15); kernel launches {reloc_launches} from the first black frame "
        f"on (expected {reloc_expect})")

    # -- phase 9: the VIP step ------------------------------------------------
    vip_record, vip_launches = vip_phase(torch, np, tklt, dev, smi)

    log("phase end times (s since start): " + ", ".join(f"{k} {v}" for k, v in MARKS.items()))
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "uvipslam_tpu"))
    if foreign:
        raise AssertionError(f"the reference stack was imported: {foreign[:5]}")

    big = [r for r in patch_rows if r["psize"] == 35 and r["shape"] == [512, 640]][0]
    full = [r for r in refine_rows if r["shape"] == [512, 640]][0]
    by_path = {"vip": vip_launches, "mono": launches, "mono_reloc": reloc_launches}
    # the VIP step is the system's main path; every path's own counts are
    # read from zero just before it and just after it. No single PyTorch
    # call computes either function (library_ms null)
    record = {"kernels": [{
        "name": "extract_patches",
        "route": "cuda",
        "source": "uvipslam_torch/csrc/extract_patches.cu",
        "replaces": "uvipslam_tpu/ops/klt.py:230",
        "launches": vip_launches["extract_patches"],
        "launches_by_path": {k: v["extract_patches"] for k, v in by_path.items()},
        "max_abs_err": patch_err,
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "alone_ms": big["alone_ms"],
        "plain_gather_alone_ms": big["plain_gather_alone_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"],
        "library_ms": None,
        "shapes": patch_rows,
    }, {
        "name": "anchor_refine",
        "route": "cuda",
        "source": "uvipslam_torch/csrc/anchor_refine.cu",
        "replaces": "uvipslam_tpu/ops/klt.py:230",
        "launches": vip_launches["anchor_refine"],
        "launches_by_path": {k: v["anchor_refine"] for k, v in by_path.items()},
        "max_abs_err": refine_err,
        "ms": full["ms"],
        "plain_ms": full["plain_ms"],
        "alone_ms": full["alone_ms"],
        "bound_ms": full["bound_ms"],
        "bound_by": full["bound_by"],
        "library_ms": None,
        "shapes": refine_rows,
    }]}
    step_record = {"step": {"frames_working": int(working.sum()), "n_frames": N_FRAMES,
                            "ate_m": ate, "ate_threshold_m": 0.02 * span,
                            "median_ms_per_frame": med, "run_medians_ms": run_meds,
                            "host_reads_per_frame": syncs / N_FRAMES,
                            "sync_calls_per_frame_audit": len(real) / audit_frames,
                            "peak_allocated_bytes": peak,
                            "profile": profile, "card": smi},
                   "reloc": {"frames_to_recover": n_rec, "centre_error": rec_err,
                             "launches": reloc_launches},
                   "vip": vip_record, "phase_end_s": MARKS}
    print(json.dumps(step_record), flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        import traceback
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
