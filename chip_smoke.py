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
     versions over 20 runs (CUDA events), and each kernel's bound; then
     both kernels over 8 streams in one launch (512x640 and 256x320, N
     400, the same psizes and iterations, the border, outside and
     non-finite points in different rows of each stream) against the
     plain versions with the same tolerances, and one row against its
     single-stream launch;
  4. small-input agreement: the first frame of a 120x160 sequence through
     the step on the card and on the CPU (plain versions) gives the same
     tracks;
  5. the mono device step at the reference's working point (512x640,
     400 tracks, kf_cap 64, pt_cap 8192, 60 frames; bench.py's settings)
     with the kernel launch counters reset just before: >= 80% of frames
     WORKING, Sim3-aligned ATE < 2% of the trajectory span, no LOST
     frame, and exactly the launches of each kernel the path's branches
     imply (`MONO_REPEATS` more runs would repeat the timing and have to
     give the same states and poses bit for bit; 0 since the fleet phases
     joined, the mono stream's two runs of phase 10 hold that);
  6. a replay of the first frames under torch.cuda sync-debug mode counts
     every host synchronization the step really makes;
  7. torch.profiler over one WORKING frame: device time per frame,
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
     tracks, kf_cap 64, pt_cap 8192; the first 90 frames of its 120-frame
     sequence; `REPEATS` more runs would
     have to be bitwise equal, 0 since phase 12 runs the VIP fleet twice):
     VIO initializes, >= 80% of frames WORKING, metric ATE
     (no scale alignment) over the WORKING frames from VIO init + 3 on
     below 5% of the trajectory span; the VIO-init frame's own ms, host
     reads, kernel launches, peak memory, a sync audit over the first 30
     or more frames and a profile split by phase over the keyframe-free VI
     frame after them (table in chiprun_out/profile_vip.txt).
 10. the mono stream with loop closing (`frontend.stream.DeviceStream`,
     mode "mono", `loop_closing=True`) fed one frame at a time over a
     512x640 `motion="loop"` sequence that returns to its start (400
     tracks, kf_cap 64, pt_cap 8192): last frame WORKING, at least one
     loop closed, the closed pair a true revisit (ground-truth centres of
     the query frame and the loop keyframe's frame closer than 0.6),
     keyframe ATE after the closure below 5% of the span, kernel launches
     as the states imply, two runs bitwise equal. Prints each closure,
     the ms of the keyframe passes by part, host reads per frame and per
     pass, peak memory, and `fuse_duplicates`' own peak;
 11. the VIP stream (`DeviceStream`, mode "vip", `loop_closing=True`)
     over a `motion="loop"` sequence with IMU and pressure: VIO
     initializes, >= 80% of frames WORKING, metric ATE below 5% of the
     trajectory's extent; a closure is printed, not gated. Then
     `global_ba_navstate` alone on the final map, on the card and on the
     CPU from the same state: the same keyframe positions within
     NAVSTATE_BA_TOL of the extent, and an objective that does not rise
 12. batched replay of the VIP step (`parallel.replay.batched_replay_vip`):
     8 streams over 8 distinct scenes in lockstep at phase 9's settings
     (512x640, 400 tracks, kf_cap 64, pt_cap 8192, the first 36 frames of
     60-frame scenes), twice (the second run up to the profile frame):
     more than half the streams initialize VIO and track with metric ATE
     (WORKING frames from VIO init + 3 on, at least 8) below 12% of the
     span, the second run is bitwise equal, kernel launches as the
     streams' states imply (one launch serves every stream that takes a
     stage). Under torch.profiler over the first frame on which every stream
     is WORKING with VIO up: launches of that batched frame below 3x a single
     stream's (phase 9's profile). Prints per stream the bench's own gates,
     ms per batched frame and per stream-frame, host reads per batched
     frame, device busy share and peak memory;
 13. batched replay of the mono step (`batched_replay`): 4 streams, 40
     frames, 512x640, phase 5's settings: more than half the streams
     WORKING on >= 60% of frames with >= 3 keyframes and Sim3-aligned ATE
     below 5% of the span, kernel launches as the states imply.
 14. the application entry point (`uvipslam_torch.app.main`, as
     `python -m uvipslam_torch.app` runs it) from a rosbag of phase 9's
     first 54 frames (images, IMU, pressure; tests/_bagwrite.py) with a
     settings YAML in the reference's schema (640x512, 400 features,
     window 8): `--device` VIP, `--device` MONO and the host MonoTracker,
     each held to the gates of the reference's app tests (VIP: >= 12
     keyframes matched, posyaw ATE below 12% of the span, VIO up; MONO:
     >= 8 matched, Sim3 ATE below 5%) and required to launch both hand
     kernels. Prints each run's FPS line, ms per frame, host reads per
     frame, launches and peak memory, and the IMU sample steps per frame
     of the bag's 64-sample windows against phase 9's. A fourth run,
     `host_vip`, is mode 2 without `--device`: the host `VipTracker`
     (two preintegrations per frame over the padded windows), held to the
     VIP gates, with exactly the launches its frames' branches imply;
 15. the host `VipTracker` directly on phase 9's sequence (512x640, its
     settings, 10-sample windows, kf_cap 64, pt_cap 8192): 60 frames with
     frames 45-47 black, the gates of the reference's
     `test_vip_recovery_after_blackout` where they apply: VIO up before
     the blackout, IMU_RELOC reached, WORKING again through a two-view
     re-initialization within `recovery_max_frames`, the last frame
     WORKING, metric ATE over the frames after VIO init below
     0.25·max(span, 0.5), median |z error| below 0.15, |bg| below 0.1, and
     exactly the launches its frames' branches imply. Prints host reads
     per frame, the median ms of the WORKING VI frames, the VIO-init
     frame's and the recovery frame's ms.

 16. the steered frontend (`ops.orb.extract_orb` with its default
     `steer=True`, and with `score_type=1`; `ops.klt.klt_track`): phase
     9's first frame after CLAHE on the card against the CPU (at least
     95% of the keypoints equal, their angles within ANGLE_TOL, bits equal
     except near a half pixel; the steered path launches no hand kernel),
     `klt_track` to a copy shifted by 2 px (`ok` equal, points within 1e-3
     px), and the reference's single-chip frontend step
     (`__graft_entry__.entry`: CLAHE, steered ORB, matching, pose
     optimization, its RandomState(0) inputs) through the port: median
     ms over 20 calls, and the steered and unsteered `extract_orb` ms;
 17. the VIP fleet sharded over processes (`parallel.replay.make_mesh`,
     `shard_stream_axis`, `batched_replay_vip(..., mesh=)`): 2 ranks
     spawned on the one card (gloo), 2 streams each, the first 4 of phase
     12's scenes for 36 frames (handed over as a file), with the gates of
     the reference's dry run (`__graft_entry__.dryrun_multichip`): some
     frame WORKING, more than half the streams VIO-initialized and below
     12% metric ATE; the all-reduced fleet counts equal on both ranks and
     to the sums over the gathered outputs, each rank's launches as its
     streams' states imply. Prints each stream's label agreement with
     phase 12's and its largest pose gap up to VIO init, and each rank's
     ms per batched frame, host reads, launches and peak memory.

 18. the device VIP step's rare branches at phase 9's settings (512x640,
     400 tracks, kf_cap 64, pt_cap 8192): (a) 70 frames with frames
     45-47 black (frames 0-44 are phase 9's run, whose state after frame
     44 it goes on from), behind phase 15's gates (VIO up before the blackout,
     the first-try lane tried on frame 45 and failing, IMU_RELOC, WORKING
     again within `recovery_max_frames`, the last frame WORKING, metric
     ATE after VIO init below 0.25·max(span, 0.5), median |z error| below
     0.15, |bg| below 0.1; phase 15's labels printed beside); (b) with
     `vio_init_min_time=1e6`, 28 frames, frames 28-30 black, then the
     last keyframe's image: LOST, WORKING within three frames, the camera
     centre within 0.15 of that keyframe's (the reference's
     tests/test_device_vip.py:91-148); (c) from phase 9's state after
     frame 35, one frame whose VI solve is made to fail: the first-try lane's
     solve reaches `reloc_min`, WORKING, the forced keyframe made. Each
     with exactly the launches its frames' branches imply, ms by branch,
     host reads and peak memory;
 19. the fleets' per-stream loops: `VipFleetStep` over 2 streams, 70
     frames (stream 0 with phase 18a's blackout, stream 1 clean): IMU_RELOC
     on stream 0 only, WORKING again within `recovery_max_frames`, each
     stream's labels equal to its single-stream run's on at least 95% of
     frames; `MonoFleetStep` over 2 streams (stream 0 phase 8's
     relocalization input, stream 1 clean): stream 0 LOST and WORKING
     again within three frames with its centre within 0.15 of the
     keyframe's, its labels equal to phase 8's; both with exactly the
     launches their streams' states imply.

`--only stream,vip_stream,fleet_kernels,fleet_vip,fleet_mono,app,host_vip,frontend_ops,shard,vip_rare,fleet_rare`
(any subset) runs those phases alone after the build and prints no result
line (`host_vip` is phase 15; `app` includes phase 14's host VIP run;
`vip_rare` and `fleet_rare` are phases 18 and 19).

The synthetic sequences render in four worker processes from the start,
beside phases 2-8. Each phase's end time goes to standard error as the
phase ends, and all of them to standard output at the end.

The last three lines of standard output are the steps' JSON record, the
per-kernel JSON record (launches per path, times, errors, bounds) and
{"ok": true, "device": {...}}. The script imports neither jax nor the reference package
uvipslam_tpu.
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 60
REPEATS = 0      # timing repeats of the VIP step after the gated run (two before the fleet
                 # phases joined; run-to-run equality of the VIP step is now held by the fleet's
                 # two runs and the VIP stream, of the mono step by the mono stream's two runs)
MONO_REPEATS = 0  # and of the mono step
BATCH = 50
VIP_FRAMES = 90          # phase 9 drives the first frames of its 120-frame sequence
VIP_AUDIT_FRAMES = 30
PROFILE_FRAMES = 1    # frames under torch.profiler in phases 7 and 9 (as in phase 12)
RELOC_WARMUP = 30     # mono frames before the blackout
# the revisit sequence of the stream phases: the reference's own revisit
# test (80 frames, seed 9, `motion="loop"`, there at 240x320 and speed 1.4)
# at 512x640 and half the speed, so that a frame moves the image by as
# many pixels as there (at speed 1.4 the 512x640 mono step is LOST from
# frame 16 on and closes nothing; at 0.7 it closes the revisit)
STREAM_FRAMES = 80
STREAM_SEED = 9
STREAM_SPEED = 0.7
VIP_STREAM_FRAMES = 100
NAVSTATE_BA_TOL = 0.005   # card vs CPU keyframe positions, as a share of the extent


T0 = time.perf_counter()
MARKS = {}      # phase -> seconds since start at its end


def log(*a):
    print(*a, flush=True)


def mark(phase):
    """Records a phase's end; the line on standard error shows how far a
    run got when it is cut. What the phase left alive is moved out of the
    garbage collector's way (its full passes walk every live object)."""
    MARKS[phase] = round(time.perf_counter() - T0, 1)
    print(f"chip_smoke: {phase} done at {MARKS[phase]} s", file=sys.stderr, flush=True)
    gc.freeze()


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


def timed_runs(torch, new_tracker, feeds, first, repeats=REPEATS):
    """`repeats` more runs after `first` (a drive() result); each must give
    the same states and poses bit for bit. Returns the run medians of the
    per-frame ms over frames 3 on."""
    _, states, Rs, ts, _, frame_ms = first
    meds = [statistics.median(frame_ms[2:])]
    for _ in range(repeats):
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


LAUNCH_NAMES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def trace_summary(events):
    """The numbers a profile reports, from a torch.profiler trace's events
    (its chrome-trace `traceEvents`; reading them takes a second where
    `key_averages()` takes up to half a minute): {name: [count, µs]} of the
    device events, {name: [count, self µs]} of the host events (their
    time less that of the events nested in them on the same thread),
    {span: [count, host µs, device µs]} of the `step.*` spans (the device
    time of the kernels launched inside them) and the kernel launches."""
    import bisect

    dev, host, spans, launch_at, threads = {}, {}, {}, {}, {}
    dev_events = []
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
            launches += e["name"] in LAUNCH_NAMES
        sp = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in evs
                    if e.get("cat") == "user_annotation" and e["name"].startswith("step."))
        for t0, t1, name in sp:
            c = spans.setdefault(name, [0, 0.0, 0.0])
            c[0] += 1
            c[1] += t1 - t0
        span_at[key] = (sp, [x[0] for x in sp])
    for e in dev_events:
        at = launch_at.get(e.get("args", {}).get("correlation"))
        if at is None or at[0] not in span_at:
            continue
        sp, starts = span_at[at[0]]
        for t0, t1, name in sp[:bisect.bisect_right(starts, at[1])]:
            if t0 <= at[1] <= t1:
                spans[name][2] += e["dur"]
    return dev, host, spans, launches


def profile_phase(torch, step, st, feeds, start, n, out_name):
    """torch.profiler over frames start..start+n-1: device busy time and
    the top operators by device and by host time (tables to
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
    t1 = time.perf_counter()
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    path = os.path.join(HERE, "chiprun_out", f"_trace_{os.getpid()}.json")
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        if os.path.exists(path):
            os.remove(path)
    dev, host, span_us, launches = trace_summary(events)
    post_s = time.perf_counter() - t1

    device_ms = sum(us for _, us in dev.values()) / 1e3
    kernels = sum(c for c, _ in dev.values())
    spans = {k: dict(host_ms=h / 1e3 / n, device_ms=d / 1e3 / n, calls=c / n)
             for k, (c, h, d) in span_us.items()}
    top_dev = sorted(dev.items(), key=lambda kv: -kv[1][1])
    top_cpu = sorted(host.items(), key=lambda kv: -kv[1][1])
    with open(os.path.join(HERE, "chiprun_out", out_name), "w") as fh:
        fh.write(f"frames {start}-{start + n - 1}; device events by device time (count, ms)\n")
        fh.writelines(f"{c:8d} {us / 1e3:10.3f}  {k}\n" for k, (c, us) in top_dev[:60])
        fh.write("\nhost events by self time (count, ms)\n")
        fh.writelines(f"{c:8d} {us / 1e3:10.3f}  {k}\n" for k, (c, us) in top_cpu[:40])
    if device_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    log(f"  frames {start}-{start + n - 1} under torch.profiler, which slows the host: "
        f"wall {wall_ms / n:.1f} ms/frame, device busy {device_ms / n:.2f} ms/frame, "
        f"{kernels / n:.0f} device kernels and {launches / n:.0f} kernel launches/frame; "
        f"{len(events)} trace events read in {post_s:.1f} s")
    log("  top device: " + "; ".join(f"{k[:60]} {us / 1e3 / n:.3f} ms x{c // n}"
                                     for k, (c, us) in top_dev[:8]))
    log("  top host: " + "; ".join(f"{k[:40]} {us / 1e3 / n:.2f} ms x{c // n}"
                                   for k, (c, us) in top_cpu[:8]))
    log("  per phase (ms/frame, host under the profiler / device): " + "; ".join(
        f"{k[5:]} {v['host_ms']:.1f} / {v['device_ms']:.2f} (x{v['calls']:.2f})"
        for k, v in sorted(spans.items(), key=lambda kv: -kv[1]["host_ms"])))
    prop = spans.get("step.propagate")
    if prop is None:
        raise AssertionError("no step.propagate span in the profile window")
    log(f"  {launches / n:.0f} kernel launches per frame; step.propagate host {prop['host_ms']:.2f} "
        f"ms / device {prop['device_ms']:.3f} ms per frame")
    # the hand-written kernels' own device time per launch on the path
    ours = {}
    for name in ("extract_patches_kernel", "anchor_refine_kernel"):
        c = sum(v[0] for k, v in dev.items() if name in k)
        us = sum(v[1] for k, v in dev.items() if name in k)
        ours[name] = dict(launches=c, device_us_per_launch=us / max(1, c))
    log("  hand kernels on the path: " + "; ".join(
        f"{k} {v['launches']} launches, {v['device_us_per_launch']:.2f} us device each"
        for k, v in ours.items()))
    return dict(frames=n, post_processing_s=post_s,
                wall_ms_per_frame_profiled=wall_ms / n, device_ms_per_frame=device_ms / n,
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
    keyframe's frame, the labels of every frame)."""
    from uvipslam_torch.frontend.tracker import LOST, WORKING

    st, step = new_tracker()
    warmup = []
    for f in range(RELOC_WARMUP):
        st, out = step(st, imgs[f])
        warmup.append(int(out.state))
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
    expect = expected_launches(states, orb_levels(*imgs.shape[1:]), prev=WORKING)
    C = centres(torch, np, [out.Rcw], [out.tcw])[0]
    err = float(np.linalg.norm(C - C_kf))
    if not err < 0.15:
        raise AssertionError(f"relocalized centre {C} is {err} from keyframe centre {C_kf}")
    if launches != expect or min(launches.values()) <= 0:
        raise AssertionError(f"relocalization path launches {launches}, expected {expect}")
    return n, err, launches, expect, kf_frame, warmup + states


def orb_levels(h, w, n=8, scale=1.2):
    """The ORB pyramid levels `extract_orb` keeps at an image size."""
    while n > 1 and min(h, w) / scale ** (n - 1) < 40:
        n -= 1
    return n


def vip_takes_stages(prev, anchored):
    """(propagates, detects) of a VIP step frame that starts in state
    `prev`: the two anchor refinements run in INITIALIZING, WORKING and
    IMU_RELOC; the shared detection (template pulls, ORB levels and the
    descriptor refresh) in NOT_INITIALIZED and WORKING, and fresh in LOST
    and in IMU_RELOC without a recovery anchor (`anchored`: the state's
    `rec_frame >= 0` at the frame's start)."""
    from uvipslam_torch.frontend.tracker import (IMU_RELOC, INITIALIZING, LOST,
                                                 NOT_INITIALIZED, WORKING)

    return (prev in (INITIALIZING, WORKING, IMU_RELOC),
            prev in (NOT_INITIALIZED, WORKING, LOST) or (prev == IMU_RELOC and not anchored))


def expected_launches_vip(states, n_orb_levels, anchored=None, prev=None):
    """Launches of each kernel implied by the branch each frame of the
    VIP step ran (`vip_takes_stages`; the state a frame starts in is the
    previous frame's output state, `prev` before the first, by default
    NOT_INITIALIZED). `anchored` [T] is needed only where a frame starts
    in IMU_RELOC. The first-try lane, the relocalization and the
    recovery's re-anchor launch neither kernel."""
    from uvipslam_torch.frontend.tracker import NOT_INITIALIZED

    detect = 2 + n_orb_levels + 1
    pulls = refines = 0
    prev = NOT_INITIALIZED if prev is None else prev
    for f, s in enumerate(states):
        prop, det = vip_takes_stages(prev, anchored[f] if anchored is not None else False)
        pulls += detect if det else 0
        refines += 2 if prop else 0
        prev = s
    return {"extract_patches": pulls, "anchor_refine": refines}


def expected_launches_host_vip(statuses, n_orb_levels):
    """Launches of each kernel implied by the host VipTracker's per-frame
    status dicts, which name the branch each frame ran: a propagation is
    two anchor refinements (every branch but NOT_INITIALIZED), a refill
    two template pulls and one per ORB level, a descriptor refresh one
    pull. VI frames (`vio`, or IMU_RELOC with an inlier count) refill and
    refresh when they hold, and make the recovery's fresh detection (a
    refill) when they fail; recovery frames refill when they re-anchor;
    the mono bootstrap's frames as `expected_launches` counts them, LOST
    propagating first (the host tracker does)."""
    refill = 2 + n_orb_levels
    pulls = refines = 0
    for st in statuses:
        s = st["state"]
        if st.get("vio") or (s == "IMU_RELOC" and "n_inliers" in st):
            refines += 2
            pulls += refill + 1 if s == "WORKING" else refill
        elif s == "IMU_RELOC" or st.get("recovery") == "re-initialized":
            refines += 2
            pulls += refill if st.get("recovery") == "re-anchored" else 0
        elif s == "NOT_INITIALIZED":
            pulls += refill
        elif s == "INITIALIZING":
            refines += 2
        elif "relocalized" in st:
            refines += 2
            pulls += refill + 1
        else:                                    # WORKING, or WORKING -> LOST
            refines += 2
            pulls += refill + 1 if s == "WORKING" else 0
    return {"extract_patches": pulls, "anchor_refine": refines}


class PreintCounter:
    """Counts the calls of `core.preintegration.preint_step` (one IMU
    sample of a running preintegration, a fixed set of launches) while
    active."""

    def __enter__(self):
        from uvipslam_torch.core import preintegration as pre

        self.mod, self.real, self.calls = pre, pre.preint_step, 0

        def counted(*a, **kw):
            self.calls += 1
            return self.real(*a, **kw)

        pre.preint_step = counted
        return self

    def __exit__(self, *exc):
        self.mod.preint_step = self.real


def vip_phase(torch, np, tklt, dev, smi, seq):
    """Phase 9 on `seq` (SEQUENCES["vip"]). Returns (the step record,
    launches on the VIP path, phase 18's prefix: the per-frame lists of
    frames 0 to RARE_BLACK[0] - 1 and the states kept on the host)."""
    from uvipslam_torch.frontend.device_vip import build_vip_tracker, make_bundles
    from uvipslam_torch.frontend.tracker import IMU_RELOC, LOST, WORKING
    from uvipslam_torch.io.synthetic import ate_rmse

    cam, cfg = vip_cam_cfg(seq.K)
    bundles = make_bundles(seq, device=dev)[:VIP_FRAMES]   # uploaded once

    def new_tracker():
        return build_vip_tracker(cam, cfg, kf_cap=64, pt_cap=8192, device=dev)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(tklt)
    # the states after frames FIRST_TRY_AFTER and RARE_BLACK[0] - 1 go to
    # the host: phase 18 starts from them
    with PreintCounter() as preint:
        step, _, run, kept = drive_vip_rare(torch, new_tracker, bundles,
                                            keep=(FIRST_TRY_AFTER, RARE_BLACK[0] - 1),
                                            keep_on="cpu")
    launches = read_launches(tklt)
    states, Rs, ts, vios, frame_ms = (run[k] for k in ("states", "Rs", "ts", "vios", "ms"))
    first = step, states, Rs, ts, vios, frame_ms
    syncs = step.host_syncs
    peak = torch.cuda.max_memory_allocated()
    run_meds = timed_runs(torch, new_tracker, bundles, first)
    med = statistics.median(run_meds)

    states = np.asarray(states)
    vios = np.asarray(vios)
    working = states == WORKING
    C = centres(torch, np, Rs, ts)
    span = float(np.linalg.norm(seq.positions_w[VIP_FRAMES - 1] - seq.positions_w[0]))
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
        f"({syncs} total), IMU sample steps {preint.calls / VIP_FRAMES:.1f}/frame (windows of "
        f"{seq.imu_mask.shape[1]}), kernel launches {launches}"
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

    # the sync audit runs at least VIP_AUDIT_FRAMES frames, up to the
    # first VI frame after them that makes no keyframe in the timed run,
    # and the profile goes on from its state over that frame. The
    # VIO-init frame alone launches ~0.4M kernels; its own time is the
    # timed run's VIO-init frame ms
    start = next((f for f in range(VIP_AUDIT_FRAMES, VIP_FRAMES) if states[f - 1] == WORKING
                  and vios[f - 1] and states[f] == WORKING and run["new_kf"][f] < 0), None)
    if start is None:
        raise AssertionError("no keyframe-free VI frame after the audit frames to profile")
    st_a, step_a = new_tracker()
    real, where, st_a = sync_audit(torch, step_a, st_a, bundles, start)
    log(f"phase VIP sync audit ({start} frames, VIO init included): "
        f"{len(real) / start:.2f} synchronizing calls/frame seen by torch.cuda "
        f"sync-debug mode, {step_a.host_syncs / start:.2f}/frame counted by the step")
    log("  by call site: " + ", ".join(f"{k} x{v}" for k, v in sorted(
        where.items(), key=lambda kv: -kv[1])[:12]))

    mark("vip_audit")
    log("phase VIP profile:")
    profile = profile_phase(torch, step_a, st_a, bundles, start, PROFILE_FRAMES,
                            "profile_vip.txt")
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
              "sync_calls_per_frame_audit": len(real) / start, "audit_frames": start,
              "preint_steps_per_frame": preint.calls / VIP_FRAMES,
              "imu_window": int(seq.imu_mask.shape[1]),
              "labels": "".join(str(x) for x in states.tolist()),
              "peak_allocated_bytes": peak, "profile": profile, "card": smi}
    prefix = {k: v[:RARE_BLACK[0]] for k, v in run.items() if k != "lane1"}
    prefix["lane1"] = [c for c in run["lane1"] if c[0] < RARE_BLACK[0]]
    return record, launches, (prefix, kept)


def drive_stream(torch, new_stream, feeds):
    """A fresh DeviceStream fed the sequence one frame at a time. Returns
    (stream, states, Rs, ts, vios, per-frame ms to a synchronize)."""
    ds = new_stream()
    states, Rs, ts, vios, frame_ms = [], [], [], [], []
    for x in feeds:
        t1 = time.perf_counter()
        out = ds.process(x)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t1) * 1e3)
        states.append(int(out.state))
        vios.append(bool(getattr(out, "vio_ok", False)))
        Rs.append(out.Rcw)
        ts.append(out.tcw)
    return ds, states, Rs, ts, vios, frame_ms


def stream_signature(ds, states, Rs, ts):
    """What two runs of a stream must share bit for bit."""
    m = ds.st.map
    passes = [(p["frame"], p["kf"], sorted(p["status"].items())) for p in ds.kf_passes]
    return (states, ds.loop_events, passes), Rs + ts + [m.kf_ns.p, m.kf_ns.R, m.kf_ns.v,
                                                        m.pt_xyz, m.kf_feat_pt, m.pt_valid]


def same_streams(torch, a, b):
    (ha, ta), (hb, tb) = a, b
    return ha == hb and all(torch.equal(x, y) for x, y in zip(ta, tb))


def log_passes(ds, n_frames):
    """The keyframe passes of a stream: closures one by one, the
    detection-only passes summed up; host reads per frame and per pass."""
    lc = ds.loop_closer
    det = [p for p in ds.kf_passes if not p["status"].get("loop")]
    closing = [p for p in ds.kf_passes if p["status"].get("loop")]
    for p in closing:
        st = p["status"]
        log(f"  loop closed at frame {p['frame']}: keyframe pair ({p['kf']}, {st['loop_kf']}), "
            f"Sim3 inliers {st['sim3_inliers']}, total matches {st['total_matches']}, scale "
            f"{st['scale']:.5f}; pass {p['ms']:.1f} ms = " + ", ".join(
                f"{k} {v:.1f}" for k, v in p["parts_ms"].items())
            + f"; {p['host_reads']} host reads")
    if det:
        ms = [p["ms"] for p in det]
        reads = [p["host_reads"] for p in det]
        verified = [p for p in det if "sim3" in p["parts_ms"]]
        log(f"  {len(det)} detection-only keyframe passes: median {statistics.median(ms):.1f} ms "
            f"(min {min(ms):.1f}, max {max(ms):.1f}), host reads per pass median "
            f"{statistics.median(reads)} (min {min(reads)}, max {max(reads)}); {len(verified)} of "
            f"them ran a Sim3 verification that was refused"
            + (f" ({', '.join(f'{p['parts_ms']['sim3']:.1f}' for p in verified)} ms)"
               if verified else ""))
    total = ds.step.host_syncs + ds.host_syncs + lc.host_reads
    log(f"  host reads: step {ds.step.host_syncs / n_frames:.2f}/frame, the stream's own "
        f"{ds.host_syncs / n_frames:.2f}/frame, the closer {lc.host_reads} over "
        f"{len(ds.kf_passes)} passes; {total / n_frames:.2f}/frame in all")
    return dict(detection_passes=len(det), closing_passes=[dict(
        frame=p["frame"], kf=p["kf"], status=p["status"], ms=p["ms"], parts_ms=p["parts_ms"],
        host_reads=p["host_reads"]) for p in closing],
        detection_ms_median=statistics.median([p["ms"] for p in det]) if det else None,
        detection_reads_median=statistics.median([p["host_reads"] for p in det]) if det else None,
        host_reads_per_frame=total / n_frames)


def stream_mono_phase(torch, np, tklt, dev, smi, seq):
    """Phase 10 on `seq` (SEQUENCES["stream_mono"]). Returns (record,
    launches on the mono stream path)."""
    from uvipslam_torch.frontend.stream import DeviceStream
    from uvipslam_torch.frontend.tracker import WORKING, TrackerConfig
    from uvipslam_torch.io.synthetic import ate_rmse
    from uvipslam_torch.mapstate.hygiene import fuse_duplicates
    from uvipslam_torch.models.camera import CameraModel

    n = STREAM_FRAMES
    cam = CameraModel.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2],
                             width=640, height=512)
    cfg = TrackerConfig(n_tracks=400, min_init_tracks=100, local_window=8, loop_closing=True)
    imgs = torch.from_numpy(seq.images.astype(np.float32)).to(dev)

    def new_stream():
        return DeviceStream(cam, cfg, kf_cap=64, pt_cap=8192, mode="mono", device=dev)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(tklt)
    ds, states, Rs, ts, _, frame_ms = drive_stream(torch, new_stream, imgs)
    launches = read_launches(tklt)
    peak = torch.cuda.max_memory_allocated()
    ds2, states2, Rs2, ts2, _, frame_ms2 = drive_stream(torch, new_stream, imgs)
    equal = same_streams(torch, stream_signature(ds, states, Rs, ts),
                         stream_signature(ds2, states2, Rs2, ts2))

    lc = ds.loop_closer
    m = ds.st.map
    expect = expected_launches(states, 8)
    meds = [statistics.median(frame_ms[2:]), statistics.median(frame_ms2[2:])]
    log(f"phase mono stream with loop closing 512x640 / 400 tracks / {n} frames: last state "
        f"{states[-1]}, {states.count(WORKING)}/{n} WORKING, {int(m.n_kf)} keyframes, "
        f"{lc.n_closed} loop(s) closed; median {statistics.median(meds):.2f} ms/frame (runs "
        f"{' / '.join(f'{x:.2f}' for x in meds)}; host clock to synchronize, keyframe passes "
        f"included), two runs bitwise equal: {equal}; kernel launches {launches} (expected "
        f"{expect}); peak allocated {peak / 2**20:.1f} MiB")
    log(f"  states {''.join(str(s) for s in states)}")
    passes = log_passes(ds, n)

    # fuse_duplicates alone on the final map: its own time and peak memory
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fuse_ms = time_ms(torch, lambda: fuse_duplicates(m), reps=5)
    fuse_peak = torch.cuda.max_memory_allocated() - base
    log(f"  fuse_duplicates alone on the final map (pt_cap 8192, blocks of 1024 rows): "
        f"{fuse_ms:.2f} ms, peak {fuse_peak / 2**20:.1f} MiB above the resident "
        f"{base / 2**20:.1f} MiB (a [P, P, 3] float32 difference alone would be "
        f"{8192 * 8192 * 12 / 2**20:.0f} MiB)")

    if states[-1] != WORKING:
        raise AssertionError(f"last frame in state {states[-1]}, not WORKING")
    if lc.n_closed < 1:
        raise AssertionError("no loop closed on the revisit")
    qf, loop_kf = ds.loop_events[0]
    lf = int(m.kf_frame_id[loop_kf])
    gap = float(np.linalg.norm(seq.positions_w[qf] - seq.positions_w[lf]))
    nk = int(m.n_kf)
    kf_frames = m.kf_frame_id[:nk].cpu().numpy()
    kf_ok = m.kf_valid[:nk].cpu().numpy()
    kfgt = seq.positions_w[kf_frames][kf_ok]
    kfp = m.kf_ns.p[:nk].double().cpu().numpy()[kf_ok]
    kfrmse, _ = ate_rmse(kfp, kfgt)
    span = float(np.abs(kfgt[:, 0]).max())
    log(f"  first closure: query frame {qf} against keyframe {loop_kf} (frame {lf}), "
        f"ground-truth centres {gap:.4f} apart (bound 0.6); keyframe ATE after the closure "
        f"{kfrmse:.5f} over {len(kfp)} keyframes (threshold {0.05 * span:.5f}, 5% of span "
        f"{span:.4f})")
    if not gap < 0.6:
        raise AssertionError(f"the closed pair is {gap} apart: not a revisit")
    if not kfrmse < 0.05 * span:
        raise AssertionError(f"keyframe ATE {kfrmse} >= 5% of span {span}")
    if min(launches.values()) <= 0 or launches != expect:
        raise AssertionError(f"kernel launches {launches}, expected {expect}")
    if not equal:
        raise AssertionError("two runs of the mono stream differ")
    mark("stream_mono")
    record = {"n_frames": n, "seed": STREAM_SEED, "speed": STREAM_SPEED,
              "frames_working": states.count(WORKING), "loops_closed": lc.n_closed,
              "revisit_gap": gap, "kf_ate": kfrmse, "kf_ate_threshold": 0.05 * span,
              "median_ms_per_frame": statistics.median(meds), "run_medians_ms": meds,
              "peak_allocated_bytes": peak, "fuse_duplicates_ms": fuse_ms,
              "fuse_duplicates_peak_bytes": fuse_peak, "passes": passes, "card": smi}
    return record, launches


def stream_vip_phase(torch, np, tklt, dev, smi, seq):
    """Phase 11 on `seq` (SEQUENCES["stream_vip"]). Returns (record,
    launches on the VIP stream path)."""
    from uvipslam_torch.core.tree import tree_map
    from uvipslam_torch.frontend.device_vip import make_bundles
    from uvipslam_torch.frontend.stream import DeviceStream
    from uvipslam_torch.frontend.tracker import IMU_RELOC, LOST, WORKING
    from uvipslam_torch.io.synthetic import ate_rmse
    from uvipslam_torch.solver.global_ba import global_ba_navstate

    n = VIP_STREAM_FRAMES
    cam, cfg = vip_cam_cfg(seq.K, loop_closing=True)
    bundles = make_bundles(seq, device=dev)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(tklt)
    ds, states, Rs, ts, vios, frame_ms = drive_stream(
        torch, lambda: DeviceStream(cam, cfg, kf_cap=64, pt_cap=8192, mode="vip", device=dev),
        bundles)
    launches = read_launches(tklt)
    peak = torch.cuda.max_memory_allocated()

    states_a = np.asarray(states)
    vios_a = np.asarray(vios)
    working = states_a == WORKING
    C = centres(torch, np, Rs, ts)
    gt = seq.positions_w
    extent = float(np.linalg.norm(gt - gt[0], axis=1).max())
    init_f = int(np.argmax(vios_a)) if vios_a.any() else -1
    sel = np.asarray([i for i in range(n) if init_f >= 0 and i >= init_f + 3 and working[i]],
                     dtype=np.int64)
    ate = float("inf")
    if len(sel) > 5:
        ate, _ = ate_rmse(C[sel], gt[sel], align_scale=False)
    clean = not ((states_a == LOST) | (states_a == IMU_RELOC)).any()
    expect = expected_launches_vip(states, orb_levels(*seq.images.shape[1:])) if clean else None
    lc = ds.loop_closer
    log(f"phase VIP stream with loop closing 512x640 / 400 tracks / {n} frames: VIO init at "
        f"frame {init_f}, {int(working.sum())}/{n} WORKING, {int((states_a == LOST).sum())} LOST, "
        f"{int((states_a == IMU_RELOC).sum())} IMU_RELOC, {lc.n_closed} loop(s) closed (printed, "
        f"not gated), metric ATE {ate:.5f} m over {len(sel)} frames (threshold "
        f"{0.05 * extent:.5f} m, 5% of the trajectory's extent {extent:.4f} m); median "
        f"{statistics.median(frame_ms[2:]):.2f} ms/frame (one run), kernel launches {launches}"
        f"{f' (expected {expect})' if expect is not None else ''}, peak allocated "
        f"{peak / 2**20:.1f} MiB")
    log(f"  states {''.join(str(s) for s in states)}")
    passes = log_passes(ds, n)
    ate_split = None
    if ds.loop_events:
        qf = ds.loop_events[0][0]
        pre, post = sel[sel < qf], sel[sel >= qf]
        ate_split = [float(ate_rmse(C[x], gt[x], align_scale=False)[0]) if len(x) > 2
                     else float("nan") for x in (pre, post)]
        log(f"  metric ATE before the first closure (frame {qf}) {ate_split[0]:.5f} m over "
            f"{len(pre)} frames, from it on {ate_split[1]:.5f} m over {len(post)} frames")
    if init_f < 0:
        raise AssertionError("VIO never initialized on the loop sequence")
    if working.sum() < 0.8 * n:
        raise AssertionError(f"only {int(working.sum())}/{n} frames WORKING")
    if not ate < 0.05 * extent:
        raise AssertionError(f"metric ATE {ate} >= 5% of the extent {extent}")
    if min(launches.values()) <= 0 or (expect is not None and launches != expect):
        raise AssertionError(f"kernel launches {launches}, expected {expect}")
    mark("stream_vip")

    # global_ba_navstate alone on the final map: card and CPU, same state
    m = ds.st.map
    step = ds.step

    def ba(mm, d):
        costs = []
        t1 = time.perf_counter()
        out = global_ba_navstate(
            mm, step.gravity.to(d), step.Rcb.to(d), step.tcb.to(d), cam.fx, cam.fy, cam.cx,
            cam.cy, cfg.gyr_noise_sd, cfg.acc_noise_sd, cfg.gyr_bias_rw2, cfg.acc_bias_rw2,
            step.depth_info, ds.sigmas.to(d), cost_out=costs)
        costs = [(float(a), float(b)) for a, b in costs]
        return out, costs, (time.perf_counter() - t1) * 1e3

    m_card, cost_card, ms_card = ba(m, dev)
    m_cpu, cost_cpu, ms_cpu = ba(tree_map(lambda a: a.cpu(), m), torch.device("cpu"))
    valid = m.kf_valid.cpu().numpy()
    p0 = m.kf_ns.p.double().cpu().numpy()[valid]
    p_card = m_card.kf_ns.p.double().cpu().numpy()[valid]
    p_cpu = m_cpu.kf_ns.p.double().numpy()[valid]
    diff = float(np.abs(p_card - p_cpu).max())
    moved = float(np.abs(p_card - p0).max())
    kept_same = float((m_card.kf_feat_pt.cpu() == m_cpu.kf_feat_pt).float().mean())
    log(f"phase global_ba_navstate alone on the final VIP map ({int(valid.sum())} keyframes, "
        f"vio_ok {bool(ds.st.vio_ok)}): card {ms_card:.0f} ms, CPU {ms_cpu:.0f} ms; keyframe "
        f"positions card vs CPU max |diff| {diff:.3e} m (bound {NAVSTATE_BA_TOL * extent:.3e}, "
        f"{NAVSTATE_BA_TOL:.1%} of the extent), moved by the BA up to {moved:.3e} m; observation "
        f"tables equal in {100 * kept_same:.2f}% of entries; objective per round start -> end: "
        f"card {cost_card}, CPU {cost_cpu}")
    if not (np.isfinite(p_card).all() and np.isfinite(p_cpu).all()):
        raise AssertionError("non-finite keyframe positions after global_ba_navstate")
    if not diff < NAVSTATE_BA_TOL * extent:
        raise AssertionError(f"global_ba_navstate card vs CPU differ by {diff} m")
    for a, b in cost_card + cost_cpu:
        if not (np.isfinite(a) and np.isfinite(b) and b <= a):
            raise AssertionError(f"global_ba_navstate objective rose: {a} -> {b}")
    mark("navstate_ba")
    record = {"n_frames": n, "vio_init_frame": init_f, "frames_working": int(working.sum()),
              "ate_metric_m": ate, "ate_threshold_m": 0.05 * extent,
              "ate_before_and_from_first_closure_m": ate_split, "loops_closed": lc.n_closed, "median_ms_per_frame": statistics.median(frame_ms[2:]),
              "peak_allocated_bytes": peak, "passes": passes,
              "navstate_ba": {"card_ms": ms_card, "cpu_ms": ms_cpu, "max_abs_diff_m": diff,
                              "bound_m": NAVSTATE_BA_TOL * extent, "cost_card": cost_card,
                              "cost_cpu": cost_cpu}, "card": smi}
    return record, launches


FLEET_S, FLEET_FRAMES, FLEET_RENDER_FRAMES = 8, 36, 60   # phase 12: the VIP fleet
MONO_FLEET_S, MONO_FLEET_FRAMES = 4, 40   # phase 13: the mono fleet
FLEET_LAUNCH_RATIO = 3.0   # batched launches per frame over a single stream's, the gate


def batched_kernel_phase(torch, tklt, dev):
    """Phase 3 for a fleet: both kernels at S = 8 in one launch against
    their plain versions (extract_patches exact, anchor_refine within
    refine_phase's tolerances), border, outside and non-finite points in
    different streams. Returns (patch rows, refine rows, max refine err)."""
    S, n, win = FLEET_S, 400, 13
    prow, rrow, max_err = [], [], 0.0
    g = torch.Generator(device=dev).manual_seed(1)
    for (h, w), psize in (((512, 640), 35), ((512, 640), 25), ((512, 640), 19),
                          ((256, 320), 27), ((256, 320), 19)):
        img = torch.rand((S, h, w), generator=g, device=dev) * 255.0
        # the special points rotate through the rows, so every stream has
        # its own border, outside and non-finite points
        pts = torch.stack([torch.roll(probe_points(torch, h, w, n, seed=40 + s), 7 * s, 0)
                           for s in range(S)]).to(dev)
        kern, lk = tklt.extract_patches_cuda(img, pts, psize)
        plain, lp = tklt._extract_patches(img, pts, psize)
        one, _ = tklt.extract_patches_cuda(img[3], pts[3], psize)
        torch.cuda.synchronize()
        if not (torch.equal(kern, plain) and torch.equal(kern[3], one) and torch.equal(
                torch.nan_to_num(lk, 7.0, 8.0, 9.0), torch.nan_to_num(lp, 7.0, 8.0, 9.0))):
            raise AssertionError(f"batched extract_patches != plain at S {S} {h}x{w} psize {psize}")
        ms = time_ms(torch, lambda: tklt.extract_patches_cuda(img, pts, psize))
        pms = time_ms(torch, lambda: tklt._extract_patches(img, pts, psize))
        out, local = torch.empty_like(kern), torch.empty_like(lk)

        def kern_only():
            for _ in range(BATCH):
                tklt.launch_extract_patches(img, pts, psize, out, local)

        kms = time_ms(torch, kern_only) / BATCH
        nbytes = sum(4 * window_pixels(torch, tklt, img[s], pts[s], psize) for s in range(S)) \
            + S * (4 * n * psize * psize + 16 * n)
        bms, by = bound(nbytes, 0)
        prow.append(dict(streams=S, shape=[h, w], psize=psize, n=n, ms=ms, plain_ms=pms,
                         alone_ms=kms, bytes=nbytes, bound_ms=bms, bound_by=by))
        log(f"  extract_patches S {S} {h}x{w} psize {psize} N {n}: exact, one launch; as called "
            f"kernel {ms:.4f} ms vs plain {pms:.4f} ms; alone {kms:.4f} ms; bound "
            f"{bms * 1e3:.3f} us ({nbytes} B)")
    for i, ((h, w), iters, mc, mr) in enumerate([((256, 320), 10, 5.0, 45.0),
                                                 ((512, 640), 8, 4.0, 32.0)]):
        a = torch.stack([wave_image(torch, h, w, dev, 0.3 * s, -0.2 * s) for s in range(S)])
        b = torch.stack([wave_image(torch, h, w, dev, 0.3 * s + 0.7, -0.2 * s - 0.4)
                         for s in range(S)])
        pts = torch.stack([torch.roll(probe_points(torch, h, w, n, seed=60 + s), 7 * s, 0)
                           for s in range(S)]).to(dev)
        T, Tx, Ty = tklt.extract_templates_fast(a, torch.nan_to_num(pts), win)
        valid = (torch.rand((S, n), generator=torch.Generator().manual_seed(i)) > 0.05).to(dev)
        args = (b, T, Tx, Ty, pts, valid)
        kw = dict(win=win, iters=iters, max_correction=mc, max_residual=mr)
        out, acc = tklt.anchor_refine_cuda(*args, **kw)
        p_out, p_acc = tklt._anchor_refine_plain(*args, **kw)
        one = tklt.anchor_refine_cuda(*(t[5] for t in args), **kw)
        _, local, good, resid, corr = tklt._refine_terms(b, T, Tx, Ty, pts, win, iters, mc)
        torch.cuda.synchronize()
        near = ((corr - mc).abs() < 1e-3) | ((resid - mr).abs() < 1e-3)
        flips = int(((acc != p_acc) & ~near).sum())
        both = acc & p_acc
        err = (out[both] - p_out[both]).abs().max().item()
        outside = ~torch.isfinite(pts).all(-1) | (pts[..., 0] < -5) | (pts[..., 1] < -5) | (
            pts[..., 0] > w + 5) | (pts[..., 1] > h + 5)
        edge_ok = not bool((acc & outside).any()) and torch.equal(
            torch.nan_to_num(out[outside], 7.0, 8.0, 9.0),
            torch.nan_to_num(pts[outside], 7.0, 8.0, 9.0))
        row_ok = torch.equal(torch.nan_to_num(one[0]), torch.nan_to_num(out[5])) and torch.equal(
            one[1], acc[5])
        share = int((acc & valid & ~outside).sum()) / int((valid & ~outside).sum())
        psize = tklt.refine_psize(win, mc)
        log(f"  anchor_refine S {S} {h}x{w} psize {psize} iters {iters} N {n}: one launch, accept "
            f"flips outside the 1e-3 margins {flips}, max |out - plain| where both accept "
            f"{err:.3e} px over {int(both.sum())} tracks, outside and non-finite points "
            f"{'rejected with out = pts' if edge_ok else 'WRONG'}, row 5 "
            f"{'equals' if row_ok else 'DIFFERS FROM'} its single-stream launch, valid inside "
            f"accepted {100 * share:.1f}%")
        if flips or not err <= 1e-3 or not edge_ok or not row_ok or share < 0.9:
            raise AssertionError(f"batched anchor_refine disagrees at {h}x{w}")
        max_err = max(max_err, err)
        ms = time_ms(torch, lambda: tklt.anchor_refine_cuda(*args, **kw))
        pms = time_ms(torch, lambda: tklt._anchor_refine_plain(*args, **kw), reps=5)
        o2, a2 = torch.empty_like(out), torch.empty_like(acc)

        def kern_only():
            for _ in range(BATCH):
                tklt.launch_anchor_refine(*args, win, iters, mc, mr, o2, a2)

        kms = time_ms(torch, kern_only) / BATCH
        work = valid & torch.isfinite(local).all(-1)
        n_work, n_good = int(work.sum()), int((work & good).sum())
        nbytes = 3 * 4 * win * win * n_work + S * n * 18 + sum(
            4 * window_pixels(torch, tklt, b[s], pts[s], psize, (work & good)[s])
            for s in range(S))
        flops = win * win * (6 * n_work + (14 * iters + 12) * n_good)
        bms, by = bound(nbytes, flops)
        rrow.append(dict(streams=S, shape=[h, w], psize=psize, iters=iters, n=n, ms=ms,
                         plain_ms=pms, alone_ms=kms, bytes=nbytes, flops=flops, bound_ms=bms,
                         bound_by=by, max_abs_err=err))
        log(f"    as called kernel {ms:.4f} ms vs plain {pms:.4f} ms; alone {kms:.4f} ms; bound "
            f"{bms * 1e3:.3f} us by {by} ({nbytes} B, {flops} flop)")
    return prow, rrow, max_err


def expected_launches_fleet(states, n_orb_levels, vip: bool, anchored=None):
    """Launches of each kernel for a fleet whose streams' per-frame states
    are `states` [S][T]: a batched stage is launched once per batched
    frame when any stream takes it. VIP: propagation and the shared
    detection (fresh for LOST and unanchored IMU_RELOC streams) are both
    batched (`vip_takes_stages`; `anchored` [S][T] as there, needed only
    where a stream starts a frame in IMU_RELOC). Mono: propagation,
    NOT_INITIALIZED's refill and WORKING's refill + refresh are batched;
    LOST's relocalization detects per stream (refill + refresh each)."""
    from uvipslam_torch.frontend.tracker import (INITIALIZING, LOST, NOT_INITIALIZED,
                                                 WORKING)

    S, T = len(states), len(states[0])
    pulls = refines = 0
    prev = [NOT_INITIALIZED] * S
    for f in range(T):
        cur = [states[s][f] for s in range(S)]
        if vip:
            takes = [vip_takes_stages(p, anchored[s][f] if anchored is not None else False)
                     for s, p in enumerate(prev)]
            refines += 2 if any(t[0] for t in takes) else 0
            pulls += 2 + n_orb_levels + 1 if any(t[1] for t in takes) else 0
        else:
            if any(p in (INITIALIZING, WORKING) for p in prev):
                refines += 2
            if any(p == NOT_INITIALIZED for p in prev):
                pulls += 2 + n_orb_levels
            if any(p == WORKING and c == WORKING for p, c in zip(prev, cur)):
                pulls += 2 + n_orb_levels + 1
            pulls += (2 + n_orb_levels + 1) * sum(p == LOST for p in prev)
        prev = cur
    return {"extract_patches": pulls, "anchor_refine": refines}


SEQ_KW = dict(H=512, W=640, n_points=6000)
IMU_KW = dict(gyr_noise=0.005, acc_noise=0.05, gyr_bias=(0.004, -0.006, 0.003),
              depth_noise=0.02, z_amp=0.5)
# the fleets' VIP scenes render at FLEET_RENDER_FRAMES and run for their
# first FLEET_FRAMES (make_sequence spreads its points over the whole
# run's extent, so a shorter render is another scene: rendered at 36
# frames, no frame of them has every stream VI and keyframe-free)
FLEET_VIP_KW = dict(n_frames=FLEET_RENDER_FRAMES, speed=1.2, **IMU_KW, **SEQ_KW)
FLEET_MONO_KW = dict(n_frames=MONO_FLEET_FRAMES, speed=0.9, **SEQ_KW)
SEQUENCES = {
    "mono": dict(n_frames=N_FRAMES, seed=7, speed=1.2, **SEQ_KW),              # phase 5
    "vip": dict(n_frames=120, seed=7, speed=1.2, **IMU_KW, **SEQ_KW),          # phase 9
    "stream_mono": dict(n_frames=STREAM_FRAMES, seed=STREAM_SEED, motion="loop",
                        speed=STREAM_SPEED, **SEQ_KW),                            # phase 10
    "stream_vip": dict(n_frames=VIP_STREAM_FRAMES, seed=STREAM_SEED, motion="loop",
                       speed=STREAM_SPEED, **IMU_KW, **SEQ_KW),                   # phase 11
    **{f"fleet_vip{s}": dict(seed=20 + s, **FLEET_VIP_KW) for s in range(FLEET_S)},
    **{f"fleet_mono{s}": dict(seed=10 + s, **FLEET_MONO_KW) for s in range(MONO_FLEET_S)},
}
FLEET_VIP_SEQS = [f"fleet_vip{s}" for s in range(FLEET_S)]
FLEET_MONO_SEQS = [f"fleet_mono{s}" for s in range(MONO_FLEET_S)]


def _one_thread():
    """A render worker's numpy on one thread: four workers with a BLAS
    pool each would oversubscribe the host the main process drives the
    card from."""
    for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[k] = "1"


def _make_sequence(kw):
    from uvipslam_torch.io.synthetic import make_sequence
    return make_sequence(**kw)


class Renders:
    """The 512x640 sequences of SEQUENCES, rendered by four worker
    processes beside the main process (a sequence takes 8-21 s of numpy
    on one core). The workers are started fresh, so none inherits the
    CUDA context. `submit` queues sequences by name, in order; `get`
    waits for one (queueing it first if it is not yet)."""

    def __init__(self):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        self.pool = ProcessPoolExecutor(max_workers=4, initializer=_one_thread,
                                        mp_context=multiprocessing.get_context("spawn"))
        self.jobs = {}

    def submit(self, *names):
        for n in names:
            if n not in self.jobs:
                self.jobs[n] = self.pool.submit(_make_sequence, SEQUENCES[n])

    def get(self, name):
        self.submit(name)
        t0 = time.time()
        seq = self.jobs[name].result()
        log(f"sequence {name} ({seq.images.shape[0]}x{seq.images.shape[1]}x"
            f"{seq.images.shape[2]}, rendered in a worker process): waited "
            f"{time.time() - t0:.1f} s for it")
        return seq

    def wait_all(self):
        """Waits for every queued sequence, then ends the workers."""
        t0 = time.time()
        for j in self.jobs.values():
            j.result()
        self.shutdown()
        log(f"all {len(self.jobs)} sequences rendered: waited {time.time() - t0:.1f} s for them")

    def shutdown(self):
        self.pool.shutdown(wait=True, cancel_futures=True)


def drive_fleet(torch, run, states0, feeds):
    """One replay of the fleet; returns (outs, fleet counts, seconds to a
    synchronize, the fleet step)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, outs, fleet = run(states0, feeds)
    torch.cuda.synchronize()
    return outs, fleet, time.perf_counter() - t0, run.step


def same_outputs(torch, a, b):
    import dataclasses
    return all(torch.equal(torch.nan_to_num(getattr(a, f.name)), torch.nan_to_num(
        getattr(b, f.name))) for f in dataclasses.fields(a))


def fleet_vip_phase(torch, np, tklt, dev, smi, single, seqs):
    """Phase 12: `batched_replay_vip`, 8 streams over 8 distinct scenes at
    full width, their first FLEET_FRAMES frames. `single` = phase 9's
    record (None on a partial run); `seqs` = the 8 sequences. Returns (the
    record, the launches, the fleet's outputs)."""
    from uvipslam_torch.core.tree import tree_map
    from uvipslam_torch.frontend.tracker import IMU_RELOC, LOST, WORKING
    from uvipslam_torch.frontend.device_vip import VipFleetStep
    from uvipslam_torch.io.synthetic import ate_rmse
    from uvipslam_torch.parallel.replay import (_over_time, batched_replay_vip, fleet_bundles,
                                                stream_generators)
    from uvipslam_torch.frontend.device_vip import VipStepOut

    S, T = FLEET_S, FLEET_FRAMES
    cam, cfg = vip_cam_cfg(seqs[0].K)
    make_states, run = batched_replay_vip(cam, cfg, kf_cap=64, pt_cap=8192, device=dev)
    feeds = tree_map(lambda a: a[:, :T].contiguous(), fleet_bundles(seqs, device=dev))
    states0 = make_states(S)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(tklt)
    outs, fleet, secs, step = drive_fleet(torch, run, states0, feeds)
    launches = read_launches(tklt)
    peak = torch.cuda.max_memory_allocated()
    syncs = step.host_syncs
    states = outs.state.cpu().numpy()
    vios = outs.vio_ok.cpu().numpy()
    # the profile frame: the first on which every stream is WORKING with
    # VIO up and none makes a keyframe, the branch phase 9's profile window
    # holds (its two frames after VIO init cannot be keyframes)
    all_vi = (states == WORKING).all(0) & vios.all(0)
    no_kf = (outs.new_kf < 0).all(0).cpu().numpy()
    starts = [f + 1 for f in range(T - 1) if all_vi[f] and all_vi[f + 1] and no_kf[f + 1]]
    if not starts:
        raise AssertionError("no keyframe-free frame with every stream WORKING and VIO up")
    start = starts[0]
    # the second run, frame by frame as `run` does it, so that the state
    # the profile starts from can be kept on the way; since phase 14 joined
    # it stops after the profile frame (frames 0..start, VIO init included:
    # it held all 60 frames bitwise equal in every run before)
    step2 = VipFleetStep(cam, cfg, 64, device=dev)
    gens = stream_generators(S, 0, dev)
    frames = [tree_map(lambda a: a[:, f], feeds) for f in range(T)]
    n2 = start + 1
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    st, outs2, st_prof = states0, [], None
    for f in range(n2):
        if f == start:
            st_prof, gen_states = st, [g.get_state() for g in gens]
        st, o = step2(st, frames[f], gens)
        outs2.append(o)
    torch.cuda.synchronize()
    secs2 = time.perf_counter() - t1
    if not same_outputs(torch, tree_map(lambda a: a[:, :n2], outs), _over_time(outs2, VipStepOut)):
        raise AssertionError("a second run of the VIP fleet differs from the first")
    del outs2
    ms_frame = 1e3 * secs / T

    n_vio = n_ate = n_bench = 0
    for s in range(S):
        C = centres(torch, np, list(outs.Rcw[s]), list(outs.tcw[s]))
        span = float(np.linalg.norm(seqs[s].positions_w[T - 1] - seqs[s].positions_w[0]))
        working = states[s] == WORKING
        init_f = int(np.argmax(vios[s])) if vios[s].any() else -1
        sel = np.asarray([i for i in range(T) if init_f >= 0 and i >= init_f + 3 and working[i]],
                         dtype=np.int64)
        ate = float("inf")
        if len(sel) >= 8:
            ate, _ = ate_rmse(C[sel], seqs[s].positions_w[sel], align_scale=False)
        n_vio += init_f >= 0
        n_ate += ate < 0.12 * span
        bench_ok = working.sum() >= 0.8 * T and ate < 0.05 * span
        n_bench += bench_ok
        log(f"  stream {s}: VIO init at frame {init_f}, {int(working.sum())}/{T} WORKING, metric "
            f"ATE {ate:.5f} m over {len(sel)} frames ({100 * ate / span:.2f}% of span "
            f"{span:.4f} m; the bench's own gates {'pass' if bench_ok else 'fail'}), states "
            f"{''.join(str(x) for x in states[s].tolist())}")
    clean = not ((states == LOST) | (states == IMU_RELOC)).any()
    expect = expected_launches_fleet(states.tolist(), orb_levels(512, 640), vip=True) \
        if clean else None
    single_ms = single["median_ms_per_frame"] if single else float("nan")
    log(f"phase VIP fleet S {S} 512x640 / 400 tracks / {T} frames: {n_vio}/{S} streams "
        f"initialized VIO, {n_ate}/{S} with metric ATE below 12% of span ({n_bench}/{S} pass the "
        f"bench's gates), fleet counts (WORKING frames, VIO streams) "
        f"{[int(x) for x in fleet]}; {ms_frame:.1f} ms per batched frame = {ms_frame / S:.1f} ms "
        f"per stream-frame (whole replay to a synchronize: {secs:.1f} s; a single stream in "
        f"phase 9: {single_ms:.1f} ms/frame); second run (stepped frame by frame over frames "
        f"0-{n2 - 1}, {secs2:.1f} s) bitwise equal; host reads {syncs / T:.2f} per batched frame ({syncs} "
        f"total, {step.fleet_syncs} of them fleet tables); kernel launches {launches}"
        f"{f' (expected {expect})' if expect is not None else ''}; peak allocated "
        f"{peak / 2**20:.1f} MiB")
    if n_vio <= S / 2 or n_ate <= S / 2:
        raise AssertionError(f"VIP fleet: {n_vio}/{S} initialized VIO, {n_ate}/{S} below 12%")
    if min(launches.values()) <= 0 or (expect is not None and launches != expect):
        raise AssertionError(f"fleet kernel launches {launches}, expected {expect}")
    mark("fleet_vip")

    for g, gs in zip(gens, gen_states):
        g.set_state(gs)
    log("phase VIP fleet profile:")
    # one frame: the profiler's post-processing of a fleet frame's events
    # takes about a minute
    profile = profile_phase(torch, lambda s_, b_: step2(s_, b_, gens), st_prof, frames, start, 1,
                            "profile_fleet_vip.txt")
    if "step.vi_ba" in profile["phases"] or (single and "step.vi_ba" in
                                             single["profile"]["phases"]):
        raise AssertionError("a profile window holds a keyframe: the launch counts compare "
                             "unlike branches")
    profile["device_busy_share"] = profile["device_ms_per_frame"] / ms_frame
    # on a partial run: a single stream's keyframe-free VI frame as phase 9
    # of a whole run of this script read it on an NVIDIA H100
    base = single["profile"]["launches_per_frame"] if single else 23957.0
    ratio = profile["launches_per_frame"] / base
    profile["launch_ratio_to_single"] = ratio
    log(f"  launches on the all-VI batched frame {start} (no stream makes a keyframe on it, as "
        f"on the single stream's profiled frames) {profile['launches_per_frame']:.0f} = "
        f"{ratio:.2f}x a single stream's {base:.0f} (gate {FLEET_LAUNCH_RATIO}x; a loop over "
        f"{S} streams would be {S}x); device busy {profile['device_ms_per_frame']:.1f} ms of "
        f"the unprofiled {ms_frame:.1f} ms batched frame = "
        f"{100 * profile['device_busy_share']:.1f}%")
    if not ratio < FLEET_LAUNCH_RATIO:
        raise AssertionError(f"fleet launches per frame {ratio:.2f}x a single stream's")
    mark("fleet_vip_profile")
    record = {"streams": S, "n_frames": T, "vio_streams": int(n_vio), "ate_ok_streams": int(n_ate),
              "bench_gate_streams": int(n_bench), "ms_per_batched_frame": ms_frame,
              "ms_per_stream_frame": ms_frame / S, "run_seconds": [secs, secs2],
              "second_run_frames": n2,
              "host_reads_per_batched_frame": syncs / T, "peak_allocated_bytes": peak,
              "profile": profile, "card": smi}
    return record, launches, outs


def fleet_mono_phase(torch, np, tklt, dev, smi, single, seqs):
    """Phase 13: `batched_replay`, 4 mono streams at full width over
    `seqs`."""
    from uvipslam_torch.frontend.tracker import LOST, WORKING, TrackerConfig
    from uvipslam_torch.io.synthetic import ate_rmse
    from uvipslam_torch.models.camera import CameraModel
    from uvipslam_torch.parallel.replay import batched_replay

    S, T = MONO_FLEET_S, MONO_FLEET_FRAMES
    k = seqs[0].K
    cam = CameraModel.create(k[0, 0], k[1, 1], k[0, 2], k[1, 2], width=640, height=512)
    cfg = TrackerConfig(n_tracks=400, min_init_tracks=100, local_window=8)
    make_states, run = batched_replay(cam, cfg, kf_cap=64, pt_cap=8192, device=dev)
    imgs = torch.from_numpy(np.stack([s.images for s in seqs]).astype(np.float32)).to(dev)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(tklt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stf, outs, fleet = run(make_states(S), imgs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches(tklt)
    peak = torch.cuda.max_memory_allocated()
    states = outs.state.cpu().numpy()
    n_kf = stf.map.n_kf.cpu().numpy()
    n_ok = 0
    for s in range(S):
        working = states[s] == WORKING
        ate = float("inf")
        if working.sum() > 5:
            C = centres(torch, np, list(outs.Rcw[s]), list(outs.tcw[s]))
            ate, _ = ate_rmse(C[working], seqs[s].positions_w[np.nonzero(working)[0]])
        span = float(np.linalg.norm(seqs[s].positions_w[-1] - seqs[s].positions_w[0]))
        ok = working.sum() >= 0.6 * T and n_kf[s] >= 3 and ate < 0.05 * span
        n_ok += ok
        log(f"  stream {s}: {int(working.sum())}/{T} WORKING, {int(n_kf[s])} keyframes, "
            f"Sim3-aligned ATE {ate:.5f} m ({100 * ate / span:.2f}% of span {span:.4f} m): "
            f"{'ok' if ok else 'not ok'}")
    clean = not (states == LOST).any()
    expect = expected_launches_fleet(states.tolist(), 8, vip=False) if clean else None
    ms_frame = 1e3 * secs / T
    single_ms = single if single else float("nan")
    log(f"phase mono fleet S {S} 512x640 / 400 tracks / {T} frames: {n_ok}/{S} streams ok, "
        f"fleet WORKING frames {int(fleet)}; {ms_frame:.1f} ms per batched frame = "
        f"{ms_frame / S:.1f} ms per stream-frame (a single stream in phase 5: {single_ms:.1f} "
        f"ms/frame); host reads {run.step.host_syncs / T:.2f} per batched frame; kernel "
        f"launches {launches}{f' (expected {expect})' if expect is not None else ''}; peak "
        f"allocated {peak / 2**20:.1f} MiB")
    if n_ok <= S / 2:
        raise AssertionError(f"mono fleet: only {n_ok}/{S} streams ok")
    if min(launches.values()) <= 0 or (expect is not None and launches != expect):
        raise AssertionError(f"mono fleet kernel launches {launches}, expected {expect}")
    mark("fleet_mono")
    record = {"streams": S, "n_frames": T, "ok_streams": int(n_ok),
              "ms_per_batched_frame": ms_frame, "ms_per_stream_frame": ms_frame / S,
              "host_reads_per_batched_frame": run.step.host_syncs / T,
              "peak_allocated_bytes": peak, "card": smi}
    return record, launches


APP_FRAMES = 54     # phase 14: the first frames of phase 9's sequence, as a bag
APP_T_BASE = 1000.0


def write_app_inputs(seq, out_dir):
    """Phase 14's inputs: the first APP_FRAMES frames of `seq` as a rosbag
    (images, the IMU stream, pressure), a settings YAML in the reference's
    schema at phase 9's width and the IMU and pressure noise of
    tests/test_parity_harness.py, and the groundtruth as TUM. Returns the
    paths."""
    import importlib.util
    import types

    from uvipslam_torch.io.evaluate import save_tum_groundtruth

    # the repo's bag writer, loaded by its path: a `tests` package installed
    # elsewhere would shadow the checkout's `tests/` directory
    spec = importlib.util.spec_from_file_location(
        "_bagwrite", os.path.join(HERE, "tests", "_bagwrite.py"))
    bagwrite = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bagwrite)

    n = APP_FRAMES
    sub = types.SimpleNamespace(images=seq.images[:n], timestamps=seq.timestamps[:n],
                                imu_omg=seq.imu_omg[:n], imu_acc=seq.imu_acc[:n],
                                imu_dt=seq.imu_dt[:n], imu_mask=seq.imu_mask[:n])
    imu_ts, omg, acc = bagwrite.imu_stream_from_sequence(sub)
    valid = seq.depth_valid[:n]
    os.makedirs(out_dir, exist_ok=True)
    bag = os.path.join(out_dir, "seq.bag")
    bagwrite.write_bag(bag, sub.images, sub.timestamps, imu_ts=imu_ts, imu_omg=omg, imu_acc=acc,
              pressure_ts=sub.timestamps[valid], pressure=seq.depth[:n][valid],
              t_base=APP_T_BASE)
    gt = os.path.join(out_dir, "stamped_groundtruth.txt")
    save_tum_groundtruth(gt, sub.timestamps + APP_T_BASE, seq.positions_w[:n])
    K = seq.K
    yaml = os.path.join(out_dir, "settings.yaml")
    with open(yaml, "w") as f:
        f.write(f"""%YAML:1.0
Camera.fx: {K[0, 0]}
Camera.fy: {K[1, 1]}
Camera.cx: {K[0, 2]}
Camera.cy: {K[1, 2]}
Camera.col: {seq.images.shape[2]}
Camera.row: {seq.images.shape[1]}
Camera.fps: 20.0
gyr.noise: 0.01
acc.noise: 0.1
gyr.rw: 5.0e-5
acc.rw: 1.0e-3
depth.noise: 0.05
ORBextractor.nFeatures: 400
LocalMapping.LocalWindowSize: 8
Mode: 2
Enhance: 0
LoopC: 0
time.Init: 1.0
Init_mode: 2
imagetopic: "/camera/image_raw"
imutopic: "/imu"
depthtopic: "/depth"
""")
    return bag, yaml, gt


def preint_cost(torch, dev, widths):
    """Launches of one IMU sample step on the card (torch.profiler), and
    the host-clock ms of one preintegration over a window of each width
    (median of 5, each ending in a synchronize)."""
    from torch.profiler import ProfilerActivity, profile

    from uvipslam_torch.core.preintegration import PreintState, preint_step, preintegrate

    f32 = dict(dtype=torch.float32, device=dev)
    st = PreintState.zero((), device=dev)
    w, a = torch.full((3,), 0.1, **f32), torch.full((3,), 9.8, **f32)
    dt = torch.full((), 5e-3, **f32)
    gyr, acc = torch.eye(3, **f32) * 1e-4, torch.eye(3, **f32) * 1e-2
    preint_step(st, w, a, dt, gyr, acc)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(10):
            preint_step(st, w, a, dt, gyr, acc)
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages() if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")) / 10
    ms = {}
    for width in widths:
        om = torch.full((width, 3), 0.1, **f32)
        ac = torch.full((width, 3), 9.8, **f32)
        dts = torch.full((width,), 5e-3, **f32)
        mask = (torch.arange(width, device=dev) < 10).to(torch.float32)
        zero = torch.zeros(3, **f32)
        runs = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            preintegrate(om, ac, dts, mask, zero, zero, 0.01, 0.1)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        ms[width] = statistics.median(runs[1:])
    return launches, ms


def app_phase(torch, np, tklt, dev, smi, seq, vip_record):
    """Phase 14: the application entry point, `uvipslam_torch.app.main`,
    from a 512x640 bag of phase 9's sequence, four runs on the card:
    (a) `--device` VIP, (b) `--device` MONO, (c) the host MonoTracker
    (MONO without `--device`), (d) the host VipTracker (VIP without
    `--device`). Gates, the reference's app tests'
    (tests/test_parity_harness.py): VIP at least 12 keyframes matched,
    posyaw ATE below 12% of the span, VIO up; MONO at least 8 matched and
    Sim3 ATE below 5%. Each run must launch both hand kernels, (d) exactly
    as its frames' branches imply. Returns (the record, launches by
    path)."""
    from uvipslam_torch import app

    out_dir = os.path.join(HERE, "chiprun_out", "app")
    t0 = time.time()
    bag, yaml, gt = write_app_inputs(seq, out_dir)
    log(f"phase app: {APP_FRAMES} frames of phase 9's sequence written as a bag "
        f"({os.path.getsize(bag) / 2**20:.1f} MiB) in {time.time() - t0:.1f} s")
    runs = {"app_vip": ["--mode", "2", "--device"], "app_mono": ["--mode", "0", "--device"],
            "host_mono": ["--mode", "0"], "host_vip": ["--mode", "2"]}
    record, by_path = {}, {}
    real_kf = app._kf_trajectory
    for name, extra in runs.items():
        metrics = os.path.join(out_dir, f"metrics_{name}.jsonl")
        out = os.path.join(out_dir, f"est_{name}.txt")
        seen = {}

        def kf_trajectory(m, vio_ok, Tbc, stamps):
            seen["vio_ok"] = bool(vio_ok)
            return real_kf(m, vio_ok, Tbc, stamps)

        app._kf_trajectory = kf_trajectory
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(tklt)
        t1 = time.time()
        try:
            with PreintCounter() as preint:
                res = app.main(["--settings", yaml, "--bag", bag, "--gt", gt, "--out", out,
                                "--metrics", metrics] + extra)
        finally:
            app._kf_trajectory = real_kf
        torch.cuda.synchronize()
        secs = time.time() - t1
        launches = read_launches(tklt)
        peak = torch.cuda.max_memory_allocated()
        rows = [json.loads(ln) for ln in open(metrics)]
        end = [r for r in rows if r["kind"] == "run_end"][0]
        names = {"NOT_INITIALIZED": "0", "INITIALIZING": "1", "WORKING": "2", "LOST": "3",
                 "IMU_RELOC": "4"}
        frames = [r for r in rows if r["kind"] == "frame"]
        states = "".join(names.get(r["state"], r["state"][-1]) for r in frames)
        vip = name in ("app_vip", "host_vip")
        expect = (expected_launches_host_vip(frames, orb_levels(*seq.images.shape[1:]))
                  if name == "host_vip" else None)
        rec = dict(ate=res, fps=end["fps"], ms_per_frame=1e3 * end["run_s"] / APP_FRAMES,
                   host_reads_per_frame=end["host_reads"] / APP_FRAMES,
                   n_keyframes=end["n_keyframes"], vio_ok=seen.get("vio_ok"),
                   launches=launches, peak_allocated_bytes=peak, main_seconds=secs, card=smi,
                   frames_working=states.count("2"),
                   preint_steps_per_frame=preint.calls / APP_FRAMES)
        log(f"  {name}: {rec['frames_working']}/{APP_FRAMES} WORKING, {res['n_matched']} "
            f"keyframes matched, {res['align']} ATE {res['ate_rmse_m']:.5f} m "
            f"({100 * res['ate_rmse_m'] / res['gt_span_m']:.2f}% of span "
            f"{res['gt_span_m']:.4f} m){', VIO up' if rec['vio_ok'] else ''}; FPS {rec['fps']} "
            f"= {rec['ms_per_frame']:.1f} ms/frame, host reads "
            f"{rec['host_reads_per_frame']:.2f}/frame, kernel launches {launches}"
            f"{f' (expected {expect})' if expect is not None else ''}, IMU sample "
            f"steps {rec['preint_steps_per_frame']:.1f}/frame, peak allocated "
            f"{peak / 2**20:.1f} MiB, main() {secs:.1f} s")
        log(f"    states {states}")
        if vip:
            ok = res["n_matched"] >= 12 and res["ate_rmse_m"] < 0.12 * res["gt_span_m"] \
                and rec["vio_ok"]
        else:
            ok = res["n_matched"] >= 8 and res["ate_rmse_m"] < 0.05 * res["gt_span_m"]
        if not ok:
            raise AssertionError(f"app run {name} fails its gates: {res}, VIO {rec['vio_ok']}")
        if min(launches.values()) <= 0 or (expect is not None and launches != expect):
            raise AssertionError(f"app run {name} launched {launches}, expected {expect}")
        record[name] = rec
        by_path[name] = launches
        mark(name)
    # the IMU window trap: the bag's bundles pad every frame's IMU window to
    # 64 samples, and the preintegration steps through every sample
    width = int(vip_record["imu_window"]) if vip_record else int(seq.imu_mask.shape[1])
    per_step, ms = preint_cost(torch, dev, (width, 64))
    steps9 = vip_record["preint_steps_per_frame"] if vip_record else float("nan")
    stepsa = record["app_vip"]["preint_steps_per_frame"]
    record["preintegration"] = dict(launches_per_sample_step=per_step,
                                    window_ms={str(k): v for k, v in ms.items()},
                                    steps_per_frame_app=stepsa, steps_per_frame_phase9=steps9)
    log(f"  IMU windows: the bag's bundles pad to 64 samples, phase 9's to {width}; IMU sample "
        f"steps per frame (VIO-init frame included) {stepsa:.1f} (app VIP) against {steps9:.1f} "
        f"(phase 9), {per_step:.0f} launches each: preintegration launches per frame "
        f"{stepsa * per_step:.0f} against {steps9 * per_step:.0f}; one preintegration over a "
        f"window of {width} takes {ms[width]:.2f} ms, of 64 {ms[64]:.2f} ms (host clock)")
    return record, by_path


HOST_VIP_FRAMES = 60            # phase 15: the first frames of phase 9's sequence
HOST_VIP_BLACK = (45, 46, 47)   # black frames (VIO is up from about frame 22)


def host_vip_blackout_phase(torch, np, tklt, dev, smi, seq):
    """Phase 15: the host VipTracker on phase 9's sequence with three
    black frames after VIO init (the reference's
    `test_vip_recovery_after_blackout` at phase 9's width). Returns (the
    record, launches)."""
    from uvipslam_torch.frontend.vip_tracker import VipTracker
    from uvipslam_torch.io.synthetic import ate_rmse

    n = HOST_VIP_FRAMES
    cam, cfg = vip_cam_cfg(seq.K)
    # the frames' inputs go to the card once, before the run
    imgs = torch.from_numpy(seq.images[:n].astype(np.float32)).to(dev)
    black = torch.zeros_like(imgs[0])
    imu = [torch.from_numpy(np.asarray(getattr(seq, k)[:n], np.float32)).to(dev)
           for k in ("imu_omg", "imu_acc", "imu_dt", "imu_mask")]
    tr = VipTracker(cam, cfg, kf_cap=64, pt_cap=8192, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(tklt)
    statuses, frame_ms, vio = [], [], []
    with PreintCounter() as preint:
        for f in range(n):
            t1 = time.perf_counter()
            st = tr.process_frame_vip(black if f in HOST_VIP_BLACK else imgs[f],
                                      *(a[f] for a in imu), depth=float(seq.depth[f]),
                                      depth_valid=bool(seq.depth_valid[f]),
                                      timestamp=float(seq.timestamps[f]))
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t1) * 1e3)
            statuses.append(st)
            vio.append(tr.vio_ok)
    launches = read_launches(tklt)
    peak = torch.cuda.max_memory_allocated()
    expect = expected_launches_host_vip(statuses, orb_levels(*seq.images.shape[1:]))

    labels = [st["state"] for st in statuses]
    init_f = vio.index(True) if any(vio) else -1
    reloc = [f for f, s in enumerate(labels) if s == "IMU_RELOC"]
    recovered = [f for f, st in enumerate(statuses) if st.get("recovery") == "re-initialized"]
    ids = [f for f, _, _ in tr.trajectory]
    C = tr.trajectory_positions()
    sel = [i for i, f in enumerate(ids) if init_f >= 0 and f > init_f]
    gt = seq.positions_w[[ids[i] for i in sel]]
    ate = z_err = span = float("inf")
    if len(sel) > 5:
        ate, _ = ate_rmse(C[sel], gt, align_scale=False)
        span = float(np.linalg.norm(gt[-1] - gt[0]))
        z_err = float(np.median(np.abs(C[sel][:, 2] - gt[:, 2])))
    bg = float(torch.linalg.vector_norm(tr.ns.bg))
    vi_ms = [m for m, st in zip(frame_ms, statuses) if st.get("vio") and st["state"] == "WORKING"]
    med = statistics.median(vi_ms) if vi_ms else float("nan")
    init_ms = frame_ms[init_f] if init_f >= 0 else float("nan")
    rec_ms = frame_ms[recovered[0]] if recovered else float("nan")
    names = {"NOT_INITIALIZED": "0", "INITIALIZING": "1", "WORKING": "2", "LOST": "3",
             "IMU_RELOC": "4"}
    log(f"phase host VIP tracker 512x640 / 400 tracks / {n} frames, frames "
        f"{HOST_VIP_BLACK[0]}-{HOST_VIP_BLACK[-1]} black: VIO init at frame {init_f}, "
        f"IMU_RELOC on frames {reloc[:1] + reloc[-1:]}, re-initialized at "
        f"{recovered[:1]}, last {labels[-1]}; metric ATE {ate:.5f} m over {len(sel)} frames "
        f"after VIO init (threshold {0.25 * max(span, 0.5):.5f} m = 0.25 max(span {span:.4f} "
        f"m, 0.5)), median |z error| {z_err:.5f} (bound 0.15), |bg| {bg:.5f} (bound 0.1)")
    log(f"  median {med:.1f} ms per WORKING VI frame ({len(vi_ms)} frames, host clock to "
        f"synchronize), VIO-init frame {init_ms:.1f} ms, recovery frame {rec_ms:.1f} ms; host "
        f"reads {tr.host_syncs / n:.2f}/frame ({tr.host_syncs} total), IMU sample steps "
        f"{preint.calls / n:.1f}/frame (windows of {seq.imu_mask.shape[1]}), kernel launches "
        f"{launches} (expected {expect}), peak allocated {peak / 2**20:.1f} MiB")
    log(f"  states {''.join(names[s] for s in labels)}")
    fails = []
    if not 0 <= init_f < HOST_VIP_BLACK[0]:
        fails.append(f"VIO init at frame {init_f}, not before the blackout")
    if not reloc:
        fails.append("IMU_RELOC never reached")
    if not recovered or recovered[0] - HOST_VIP_BLACK[0] > cfg.recovery_max_frames:
        fails.append(f"no re-initialization within {cfg.recovery_max_frames} frames")
    if labels[-1] != "WORKING":
        fails.append(f"last state {labels[-1]}")
    if not ate < 0.25 * max(span, 0.5):
        fails.append(f"metric ATE {ate} >= 0.25 max(span {span}, 0.5)")
    if not z_err < 0.15:
        fails.append(f"median |z error| {z_err} >= 0.15")
    if not bg < 0.1:
        fails.append(f"|bg| {bg} >= 0.1")
    if min(launches.values()) <= 0 or launches != expect:
        fails.append(f"kernel launches {launches}, expected {expect}")
    if fails:
        raise AssertionError("host VIP blackout: " + "; ".join(fails))
    mark("host_vip_blackout")
    record = {"n_frames": n, "black": list(HOST_VIP_BLACK), "vio_init_frame": init_f,
              "imu_reloc_frames": reloc, "recovered_frame": recovered[0],
              "ate_metric_m": ate, "ate_threshold_m": 0.25 * max(span, 0.5),
              "median_z_error_m": z_err, "bg_norm": bg, "median_ms_per_vi_frame": med,
              "vio_init_frame_ms": init_ms, "recovery_frame_ms": rec_ms,
              "host_reads_per_frame": tr.host_syncs / n,
              "preint_steps_per_frame": preint.calls / n, "launches": launches,
              "labels": "".join(names[s] for s in labels),
              "peak_allocated_bytes": peak, "card": smi}
    return record, launches


ORB_HALF_BAND = 1e-3   # px: a rotated BRIEF point this close to a half pixel may round either way
ANGLE_TOL = 1e-5       # rad, the steered angles card vs CPU (float64 moment sums on both)
SHARD_WORLD, SHARD_STREAMS, SHARD_FRAMES = 2, 4, 36   # phase 17: ranks, streams, frames
SHARD_DEADLINE = 240.0  # s, for the ranks to finish (the gloo timeout too); they take ~40


def near_half_bits(np, pattern, xy, level, angle, dangle, scale=1.2):
    """[N, 256] True where one of a bit's rotated pattern points lies
    within ORB_HALF_BAND + its radius x |dangle| of a half pixel on its
    level (tests/test_torch_frontend_ops.py's rule)."""
    s = np.float32(scale) ** level.astype(np.float32)
    xl = np.round(xy / s[:, None])
    ca, sa = np.cos(angle.astype(np.float64)), np.sin(angle.astype(np.float64))
    pat = pattern.astype(np.float64)
    near = np.zeros((len(xy), pat.shape[0]), bool)
    for px, py in ((pat[:, 0], pat[:, 1]), (pat[:, 2], pat[:, 3])):
        band = ORB_HALF_BAND + np.hypot(px, py)[None] * np.abs(dangle)[:, None]
        for c in (xl[:, :1] + px * ca[:, None] - py * sa[:, None],
                  xl[:, 1:] + px * sa[:, None] + py * ca[:, None]):
            near |= np.abs(np.abs(c - np.floor(c)) - 0.5) < band
    return near


def compare_orb(np, torb, card, cpu, label):
    """Card vs CPU features of one image: at least 95% of the card's
    keypoints are CPU keypoints (same pixel and level; a resized level's
    float32 sums may round a FAST test the other way, as in phase 4),
    their angles within ANGLE_TOL, their bits equal except near a half
    pixel. Returns the counts for the record."""
    g = {k: getattr(card, k).cpu().numpy() for k in ("xy", "level", "angle", "desc", "valid")}
    c = {k: getattr(cpu, k).numpy() for k in ("xy", "level", "angle", "desc", "valid")}
    index = {(x, y, l): i for i, ((x, y), l, v) in enumerate(zip(c["xy"].tolist(),
                                                                  c["level"].tolist(),
                                                                  c["valid"].tolist())) if v}
    pairs = [(j, index[(x, y, l)]) for j, ((x, y), l, v) in enumerate(
        zip(g["xy"].tolist(), g["level"].tolist(), g["valid"].tolist()))
        if v and (x, y, l) in index]
    n_card = int(g["valid"].sum())
    gj = np.asarray([p[0] for p in pairs], dtype=np.int64)
    ci = np.asarray([p[1] for p in pairs], dtype=np.int64)
    dang = g["angle"][gj] - c["angle"][ci]
    near = near_half_bits(np, torb.BRIEF_PATTERN, c["xy"][ci], c["level"][ci], c["angle"][ci],
                          dang)
    off = g["desc"][gj] != c["desc"][ci]
    identical = all(np.array_equal(g[k], c[k]) for k in ("xy", "level", "valid", "desc"))
    out = {"card_keypoints": n_card, "equal_keypoints": len(pairs), "all_slots_identical":
           identical, "max_angle_diff_rad": float(np.abs(dang).max()) if len(pairs) else 0.0,
           "bits_near_half": int(near.sum()), "bits_differing": int(off.sum())}
    log(f"  {label}: {len(pairs)}/{n_card} card keypoints are CPU keypoints (every slot "
        f"identical: {identical}); angles within {out['max_angle_diff_rad']:.3g} rad; "
        f"{out['bits_differing']} bits differ, {out['bits_near_half']} lie near a half pixel")
    if len(pairs) < 0.95 * n_card or n_card < 300:
        raise AssertionError(f"{label}: {len(pairs)}/{n_card} keypoints equal card vs CPU")
    if out["max_angle_diff_rad"] > ANGLE_TOL:
        raise AssertionError(f"{label}: angles {out['max_angle_diff_rad']} rad apart")
    if (off & ~near).any():
        raise AssertionError(f"{label}: {int((off & ~near).sum())} bits differ away from a half")
    return out


def frontend_ops_phase(torch, np, tklt, dev, smi, seq):
    """Phase 16: the steered frontend on the card against the CPU, and the
    reference's single-chip frontend step (`__graft_entry__.entry`)
    through the port."""
    import torch.nn.functional as F

    from uvipslam_torch.ops import orb as torb
    from uvipslam_torch.ops.clahe import clahe
    from uvipslam_torch.ops.hamming import match_best
    from uvipslam_torch.ops.klt import build_flow_pyramid, klt_track
    from uvipslam_torch.solver.pose_opt import pose_optimization_se3

    enh = clahe(torch.from_numpy(seq.images[0].astype(np.float32)))
    # the same content 2 px to the right (the left edge replicated)
    shifted = F.pad(enh[None, None, :, :-2], (2, 0, 0, 0), mode="replicate")[0, 0].contiguous()
    no_occ = (torch.zeros((1, 2)), torch.zeros(1, dtype=torch.bool))
    no_occ_card = tuple(t.to(dev) for t in no_occ)
    enh_card = enh.to(dev)
    record, cpu = {}, {}
    reset_launches(tklt)
    for label, kw in (("steered", dict(steer=True)),
                      ("steered, Harris ranking", dict(steer=True, score_type=1))):
        cpu[label] = torb.extract_orb(enh, *no_occ, n_features=400, **kw)
        card = torb.extract_orb(enh_card, *no_occ_card, n_features=400, **kw)
        record[label] = compare_orb(np, torb, card, cpu[label], f"extract_orb {label}")
    steered_launches = read_launches(tklt)
    if any(steered_launches.values()):
        raise AssertionError(f"the steered path launched hand kernels: {steered_launches}")

    # klt_track from the frame to its shifted copy, on the CPU's steered keypoints
    pts, valid = cpu["steered"].xy, cpu["steered"].valid
    kw = dict(win=21, iters=10, levels=4)
    nc, okc = klt_track(build_flow_pyramid(enh, 4), build_flow_pyramid(shifted, 4), pts, pts,
                        valid, **kw)
    ng, okg = klt_track(build_flow_pyramid(enh_card, 4), build_flow_pyramid(shifted.to(dev), 4),
                        pts.to(dev), pts.to(dev), valid.to(dev), **kw)
    ok_same = torch.equal(okg.cpu(), okc)
    both = okc & okg.cpu()
    gap = float((ng.cpu() - nc)[both].abs().max()) if both.any() else 0.0
    flow = (nc - pts)[okc]
    med = flow.median(dim=0).values.tolist() if okc.any() else [float("nan")] * 2
    log(f"  klt_track (21 px window, 4 levels) over a 2 px shift: {int(okg.sum())}/"
        f"{int(valid.sum())} tracked on the card, ok {'equal' if ok_same else 'DIFFERS'} card vs "
        f"CPU, points within {gap:.2e} px, median flow ({med[0]:.3f}, {med[1]:.3f})")
    if not ok_same or gap > 1e-3 or okc.sum() < 100 or abs(med[0] - 2.0) > 0.1:
        raise AssertionError(f"klt_track: ok equal {ok_same}, gap {gap}, tracked "
                             f"{int(okc.sum())}, median flow {med}")

    # the reference's frontend step (`__graft_entry__.entry`): CLAHE, steered
    # ORB, Hamming matching, pose optimization, its RandomState(0) inputs
    NF = 400
    rs = np.random.RandomState(0)
    img = torch.from_numpy(rs.uniform(0, 255, (512, 640)).astype(np.float32)).to(dev)
    prev_desc = torch.from_numpy(rs.randint(0, 2, (NF, 256)).astype(np.int8)).to(dev)
    prev_valid = torch.ones(NF, dtype=torch.bool, device=dev)
    pts_w = torch.from_numpy(rs.uniform(-2, 2, (NF, 3)).astype(np.float32)
                             + np.array([0, 0, 5], np.float32)).to(dev)
    uvs = torch.from_numpy(rs.uniform(0, 500, (NF, 2)).astype(np.float32)).to(dev)
    eye, zero3, ones = (torch.eye(3, device=dev), torch.zeros(3, device=dev),
                        torch.ones(NF, device=dev))

    def frontend_step():
        feats = torb.extract_orb(clahe(img), *no_occ_card, n_features=NF)
        idx, dist, ok = match_best(feats.desc, prev_desc, feats.valid, prev_valid, max_dist=64.0,
                                   ratio=0.9)
        R, t, inl, n_in = pose_optimization_se3(eye, zero3, pts_w, uvs, feats.valid, ones, 413.3,
                                                413.7, 305.9, 259.4, rounds=2, iters=4)
        return R, t, n_in + torch.sum(ok)

    R, t, n = frontend_step()
    if not (torch.isfinite(R).all() and torch.isfinite(t).all()) or R.shape != (3, 3):
        raise AssertionError("the frontend step gave a non-finite pose")
    step_ms = time_ms(torch, frontend_step, 20)
    orb_ms = {steer: time_ms(torch, lambda: torb.extract_orb(enh_card, *no_occ_card,
                                                             n_features=NF, steer=steer), 20)
              for steer in (True, False)}
    log(f"phase steered frontend: the reference's frontend step (CLAHE, steered ORB, matching, "
        f"pose optimization; 512x640, 400 features) {step_ms:.2f} ms median over 20 calls "
        f"(CUDA events); extract_orb steered {orb_ms[True]:.2f} ms / unsteered "
        f"{orb_ms[False]:.2f} ms; the steered path launched no hand kernel")
    mark("frontend_ops")
    record.update({"klt_ok_equal": ok_same, "klt_max_point_gap_px": gap,
                   "klt_tracked": int(okg.sum()), "frontend_step_ms": step_ms,
                   "extract_orb_steered_ms": orb_ms[True],
                   "extract_orb_unsteered_ms": orb_ms[False], "card": smi})
    return record, steered_launches


def shard_rank(rank, world, port, job):
    """One rank of phase 17, in a spawned process: joins the gloo group,
    runs its rows of the VIP fleet on the card through the mesh, and saves
    what `run` returned with its own counts to `rank<r>.pt`."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=SHARD_DEADLINE))
    try:
        import uvipslam_torch  # noqa: F401  (turns TF32 off)
        from uvipslam_torch import kernels
        from uvipslam_torch.frontend.device_vip import FrameBundle
        from uvipslam_torch.ops import klt as tklt
        from uvipslam_torch.parallel.replay import (batched_replay_vip, make_mesh,
                                                    shard_stream_axis)

        kernels.load()                       # built by the parent: the hashed library exists
        data = np.load(job["inputs"])
        cam, cfg = vip_cam_cfg(data["K"])
        mesh = make_mesh(world)
        feeds = FrameBundle(**{n: torch.from_numpy(data[n]) for n in FrameBundle.__dataclass_fields__})
        make_states, run = batched_replay_vip(cam, cfg, kf_cap=64, pt_cap=8192, mesh=mesh)
        local = shard_stream_axis(mesh, feeds)
        states0 = make_states(job["S"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(tklt)
        t0 = time.perf_counter()
        stf, outs, fleet = run(states0, local)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        torch.save({"outs": {f: getattr(outs, f).cpu() for f in outs.__dataclass_fields__},
                    "fleet": [int(x) for x in fleet], "vio_ok_local": stf.vio_ok.cpu(),
                    "seconds": secs, "host_syncs": run.step.host_syncs,
                    "launches": read_launches(tklt), "peak": torch.cuda.max_memory_allocated(),
                    "device": str(mesh.device), "card": torch.cuda.get_device_name(mesh.device)},
                   os.path.join(job["dir"], f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def shard_phase(torch, np, smi, seqs, fleet_outs):
    """Phase 17: `batched_replay_vip` sharded over SHARD_WORLD processes
    on the one card (gloo), SHARD_STREAMS of phase 12's scenes for
    SHARD_FRAMES frames. `fleet_outs` = phase 12's outputs (None on a
    partial run)."""
    import multiprocessing
    import shutil
    import socket

    from uvipslam_torch.frontend.tracker import IMU_RELOC, LOST, WORKING
    from uvipslam_torch.io.synthetic import ate_rmse

    S, T, W_ = SHARD_STREAMS, SHARD_FRAMES, SHARD_WORLD
    work = os.path.join(HERE, "chiprun_out", "shard")
    os.makedirs(work, exist_ok=True)
    try:
        fields = dict(img="images", imu_omg="imu_omg", imu_acc="imu_acc", imu_dt="imu_dt",
                      imu_mask="imu_mask", depth="depth", depth_valid="depth_valid",
                      timestamp="timestamps")
        arrays = {k: np.stack([getattr(q, v)[:T] for q in seqs[:S]]) for k, v in fields.items()}
        arrays = {k: a.astype(bool) if k == "depth_valid" else a.astype(np.float32)
                  for k, a in arrays.items()}
        np.savez(os.path.join(work, "inputs.npz"), K=seqs[0].K, **arrays)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        job = dict(S=S, inputs=os.path.join(work, "inputs.npz"), dir=work)
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=shard_rank, args=(r, W_, port, job)) for r in range(W_)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        # a rank that fails ends the wait: its peer would block in a
        # collective until the gloo timeout
        end = time.monotonic() + SHARD_DEADLINE
        while time.monotonic() < end and any(p.is_alive() for p in procs) and not any(
                p.exitcode not in (None, 0) for p in procs):
            time.sleep(0.2)
        wall = time.perf_counter() - t0
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        if hung or any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"sharded fleet: ranks {hung} hung, exit codes "
                                 f"{[p.exitcode for p in procs]}")
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt")) for r in range(W_)]
    finally:
        shutil.rmtree(work, ignore_errors=True)

    outs = ranks[0]["outs"]
    for r in ranks[1:]:
        if r["fleet"] != ranks[0]["fleet"] or not all(torch.equal(torch.nan_to_num(r["outs"][f]),
                                                                  torch.nan_to_num(outs[f]))
                                                      for f in outs):
            raise AssertionError("the ranks returned different global outputs")
    states, vios = outs["state"].numpy(), outs["vio_ok"].numpy()
    n_working, n_vio = ranks[0]["fleet"]
    sums = [int((states == WORKING).sum()), int(sum(int(r["vio_ok_local"].sum()) for r in ranks))]
    if [n_working, n_vio] != sums or n_vio != int(vios[:, -1].sum()):
        raise AssertionError(f"all-reduced fleet {[n_working, n_vio]} against the gathered "
                             f"outputs' sums {sums} / {int(vios[:, -1].sum())}")
    n_ate = 0
    for s in range(S):
        C = centres(torch, np, list(outs["Rcw"][s]), list(outs["tcw"][s]))
        span = float(np.linalg.norm(seqs[s].positions_w[T - 1] - seqs[s].positions_w[0]))
        init_f = int(np.argmax(vios[s])) if vios[s].any() else -1
        sel = np.asarray([i for i in range(T) if init_f >= 0 and i >= init_f + 3
                          and states[s, i] == WORKING], dtype=np.int64)
        ate = float("inf")
        if len(sel) >= 8:
            ate, _ = ate_rmse(C[sel], seqs[s].positions_w[sel], align_scale=False)
        n_ate += ate < 0.12 * span
        agree = ""
        if fleet_outs is not None:
            ref = fleet_outs.state[s, :T].cpu().numpy()
            upto = init_f if init_f >= 0 else T
            gap = float((outs["tcw"][s, :upto] - fleet_outs.tcw[s, :upto].cpu()).abs().max()) \
                if upto > 0 else 0.0
            agree = (f"; labels equal to phase 12's stream on {int((ref == states[s]).sum())}/{T} "
                     f"frames, largest tcw gap up to VIO init {gap:.2e}")
        log(f"  stream {s} (rank {s // (S // W_)}): VIO init at frame {init_f}, "
            f"{int((states[s] == WORKING).sum())}/{T} WORKING, metric ATE {ate:.5f} m over "
            f"{len(sel)} frames ({100 * ate / span:.2f}% of span {span:.4f} m){agree}")
    clean = not ((states == LOST) | (states == IMU_RELOC)).any()
    per_rank = []
    for i, r in enumerate(ranks):
        rows = states[i * (S // W_):(i + 1) * (S // W_)].tolist()
        expect = expected_launches_fleet(rows, orb_levels(512, 640), vip=True) if clean else None
        per_rank.append({"ms_per_batched_frame": 1e3 * r["seconds"] / T,
                         "host_reads_per_batched_frame": r["host_syncs"] / T,
                         "launches": r["launches"], "expected_launches": expect,
                         "peak_allocated_bytes": r["peak"], "device": r["device"]})
        log(f"  rank {i} on {r['device']}: {1e3 * r['seconds'] / T:.1f} ms per batched frame of "
            f"{S // W_} streams ({r['seconds']:.1f} s to a synchronize, the two collectives "
            f"included), host reads {r['host_syncs'] / T:.2f} per batched frame, kernel "
            f"launches {r['launches']}{f' (expected {expect})' if expect else ''}, peak "
            f"allocated {r['peak'] / 2**20:.1f} MiB")
        if min(r["launches"].values()) <= 0 or (expect is not None and r["launches"] != expect):
            raise AssertionError(f"rank {i} kernel launches {r['launches']}, expected {expect}")
    log(f"phase sharded VIP fleet: {W_} ranks x {S // W_} streams on one card (gloo), "
        f"{T} frames at 512x640 / 400 tracks: fleet (WORKING frames, VIO streams) "
        f"{[n_working, n_vio]} equal on every rank and to the gathered outputs' sums; "
        f"{n_ate}/{S} streams below 12% metric ATE; {wall:.1f} s from spawning to the last exit")
    if n_working <= 0 or n_vio <= S / 2 or n_ate <= S / 2:
        raise AssertionError(f"sharded fleet gates: WORKING {n_working}, VIO {n_vio}/{S}, "
                             f"ATE {n_ate}/{S}")
    mark("shard")
    record = {"ranks": W_, "streams": S, "n_frames": T, "fleet": [n_working, n_vio],
              "ate_ok_streams": int(n_ate), "wall_seconds": wall, "per_rank": per_rank,
              "card": smi}
    return record, {f"shard_vip_rank{i}": r["launches"] for i, r in enumerate(ranks)}


RARE_FRAMES = 70                  # phases 18a and 19a: the first frames of phase 9's sequence
RARE_BLACK = HOST_VIP_BLACK       # black frames after VIO init, as in phase 15
PREINIT_FRAMES, PREINIT_BLACK = 28, (28, 29, 30)   # phase 18b (tests/test_device_vip.py:91-148)
FIRST_TRY_AFTER = 35              # phase 18c starts from the state after this WORKING VI frame


def vip_cam_cfg(K, **kw):
    """The 512x640 camera of intrinsics K and phase 9's `VipConfig`
    (bench.py's VIP settings), `kw` replacing fields."""
    from uvipslam_torch.frontend.vip_tracker import VipConfig
    from uvipslam_torch.models.camera import CameraModel

    cam = CameraModel.create(K[0, 0], K[1, 1], K[0, 2], K[1, 2], width=640, height=512)
    cfg = VipConfig(**{**dict(n_tracks=400, min_init_tracks=100, local_window=8,
                              gyr_noise_sd=0.01, acc_noise_sd=0.1, depth_noise_sd=0.05,
                              vio_init_min_kfs=6, vio_init_min_time=1.0), **kw})
    return cam, cfg


def mono_inputs(torch, np, dev, seq):
    """Phase 5's sequence (SEQUENCES["mono"]), camera, `TrackerConfig` and
    images on the card."""
    from uvipslam_torch.frontend.tracker import TrackerConfig
    from uvipslam_torch.models.camera import CameraModel

    cam = CameraModel.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2],
                             width=640, height=512)
    cfg = TrackerConfig(n_tracks=400, min_init_tracks=100, local_window=8)
    return seq, cam, cfg, torch.from_numpy(seq.images.astype(np.float32)).to(dev)


def blacked(torch, bundles, frames):
    """The bundles with the images of `frames` black (IMU and pressure kept)."""
    import dataclasses
    return [dataclasses.replace(b, img=torch.zeros_like(b.img)) if f in frames else b
            for f, b in enumerate(bundles)]


def clone_vip_state(torch, st, device=None):
    """A copy of a single-stream VIP state that shares no tensor and no
    generator with it, its tensors on `device` (default: where they are;
    the generator stays on the state's device)."""
    import dataclasses
    from uvipslam_torch.core.tree import tree_map

    gen = torch.Generator(device=st.gen.device)
    gen.set_state(st.gen.get_state())
    copy = torch.clone if device is None else (lambda t: t.to(device, copy=True))
    return dataclasses.replace(tree_map(copy, st), gen=gen)


def seeded_generators(torch, dev, n):
    """n generators seeded as a single-stream run's (`build_vip_tracker`,
    `build_tracker`: seed 0)."""
    gens = []
    for _ in range(n):
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        gens.append(g)
    return gens


class FirstTryLog:
    """While active, records each call of a `VipStep`'s first-try lane
    (`_vi_lane1`, run when the VI solve fails) as (frame, the label it
    returned); the caller sets `frame` before each step."""

    def __init__(self, step):
        self.step, self.frame, self.calls = step, -1, []

    def __enter__(self):
        real = self.step._vi_lane1

        def lane1(*a, **kw):
            out = real(*a, **kw)
            self.calls.append((self.frame, out[1]))
            return out

        self.step._vi_lane1 = lane1
        return self

    def __exit__(self, *exc):
        del self.step._vi_lane1


def drive_vip_rare(torch, new_tracker, feeds, first=0, keep=(), keep_on=None):
    """A tracker from `new_tracker()` = (state, step) over `feeds` (frames
    `first`, `first` + 1, ...) one frame at a time, the step's first-try
    lane logged. Per frame: the label, the VIO flag, whether the frame
    starts with a recovery anchor (read before the step, outside its
    timing), `new_kf`, the camera pose and the ms (host clock to a
    synchronize). No reference to the initial state outlives its first
    frame. Returns (the step, the final state, the per-frame lists with
    the lane's (frame, label) calls under "lane1", {frame: a copy of the
    state after it} for the frames in `keep`, on `keep_on`, which
    default to the state's device, copied outside the frames' timing)."""
    run = {k: [] for k in ("states", "vios", "anchored", "new_kf", "Rs", "ts", "ms")}
    kept = {}
    st, step = new_tracker()
    with FirstTryLog(step) as lane1:
        for f, b in enumerate(feeds, start=first):
            run["anchored"].append(bool(st.rec_frame >= 0))
            lane1.frame = f
            t1 = time.perf_counter()
            st, out = step(st, b)
            torch.cuda.synchronize()
            run["ms"].append((time.perf_counter() - t1) * 1e3)
            run["states"].append(int(out.state))
            run["vios"].append(bool(out.vio_ok))
            run["new_kf"].append(int(out.new_kf))
            run["Rs"].append(out.Rcw)
            run["ts"].append(out.tcw)
            if f in keep:
                kept[f] = clone_vip_state(torch, st, keep_on)
    run["lane1"] = lane1.calls
    return step, st, run, kept


def vip_branches(states, vios, anchored, lane1_calls):
    """The branch each frame of a VIP step run took, named from the state
    it started in, its anchor flag, the first-try lane's calls and its
    outcome."""
    from uvipslam_torch.frontend.tracker import IMU_RELOC, LOST, WORKING

    lane1 = dict(lane1_calls)
    prev, prev_vio, names = None, False, []
    for f, (s, v, a) in enumerate(zip(states, vios, anchored)):
        if v and not prev_vio:
            name = "vio_init"
        elif prev == WORKING and prev_vio:
            name = "vi" if f not in lane1 else (
                "first_try" if lane1[f] == WORKING else "lane1_failed")
        elif prev == WORKING:
            name = "mono"
        elif prev == IMU_RELOC:
            name = ("recovered" if s == WORKING else "imu_reloc") if a else "anchor_capture"
        elif prev == LOST:
            name = "relocalized" if s == WORKING else "lost"
        else:
            name = "bootstrap"
        names.append(name)
        prev, prev_vio = s, v
    return names


def ms_by_branch(names, ms):
    """{branch: [frames, median ms]} of one run."""
    out = {}
    for n in dict.fromkeys(names):
        x = [m for b, m in zip(names, ms) if b == n]
        out[n] = [len(x), statistics.median(x)]
    return out


def fmt_branches(by):
    return ", ".join(f"{k} {v[1]:.1f} ms (x{v[0]})" for k, v in by.items())


def vip_rare_phase(torch, np, tklt, dev, smi, seq, host_labels=None, prefix=None):
    """Phase 18: the device VIP step's rare branches at phase 9's settings.
    (a) three black frames after VIO init: the first-try lane fails,
    IMU_RELOC dead-reckons and re-anchors back to WORKING, behind phase
    15's gates; (b) a blackout before VIO init: LOST, then the
    relocalization against the last keyframe (the reference's
    tests/test_device_vip.py:91-148); (c) the first-try lane holding on
    a clean frame after VIO init when the VI solve is made to fail.
    (a)'s frames before the blackout are phase 9's (the same inputs, the
    same seed): `prefix` = phase 9's (per-frame lists, kept states), run
    here when None; (a) drives frames RARE_BLACK[0] on from the kept
    state, and (c) starts from the state after FIRST_TRY_AFTER.
    `host_labels`: phase 15's labels, printed beside (a)'s. Returns (the
    record, launches by path, (a)'s labels)."""
    import dataclasses

    from uvipslam_torch.frontend import device_vip
    from uvipslam_torch.frontend.device_vip import VipStep, build_vip_tracker, make_bundles
    from uvipslam_torch.frontend.tracker import IMU_RELOC, LOST, WORKING
    from uvipslam_torch.io.synthetic import ate_rmse

    cam, cfg = vip_cam_cfg(seq.K)
    n_levels = orb_levels(*seq.images.shape[1:])
    bundles = make_bundles(seq, device=dev)
    n, b0 = RARE_FRAMES, RARE_BLACK[0]

    # (a) post-init blackout
    if prefix is None:
        _, _, pre, kept = drive_vip_rare(
            torch, lambda: build_vip_tracker(cam, cfg, kf_cap=64, pt_cap=8192, device=dev),
            bundles[:b0], keep=(FIRST_TRY_AFTER, b0 - 1), keep_on="cpu")
    else:
        pre, kept = prefix
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(tklt)
    step, st, own, _ = drive_vip_rare(
        torch, lambda: (clone_vip_state(torch, kept[b0 - 1], dev), VipStep(cam, cfg, 64, device=dev)),
        blacked(torch, bundles[:n], RARE_BLACK)[b0:], first=b0)
    launches_a = read_launches(tklt)
    peak_a = torch.cuda.max_memory_allocated()
    expect_a = expected_launches_vip(own["states"], n_levels, own["anchored"],
                                     prev=pre["states"][-1])
    run = {k: pre[k] + own[k] for k in own}
    lane1 = run["lane1"]
    labels = run["states"]
    init_f = run["vios"].index(True) if any(run["vios"]) else -1
    reloc = [f for f, s in enumerate(labels) if s == IMU_RELOC]
    back = [f for f in range(reloc[0], n) if labels[f] == WORKING] if reloc else []
    C = centres(torch, np, run["Rs"], run["ts"])
    sel = [f for f in range(n) if 0 <= init_f < f]
    ate = z_err = span = float("inf")
    if len(sel) > 5:
        gt = seq.positions_w[sel]
        ate, _ = ate_rmse(C[sel], gt, align_scale=False)
        span = float(np.linalg.norm(gt[-1] - gt[0]))
        z_err = float(np.median(np.abs(C[sel][:, 2] - gt[:, 2])))
    bg = float(torch.linalg.vector_norm(st.ns.bg))
    by_a = ms_by_branch(vip_branches(labels, run["vios"], run["anchored"], lane1),
                        run["ms"])
    log(f"phase VIP step rare branches (a) 512x640 / 400 tracks / {n} frames, frames "
        f"{b0}-{RARE_BLACK[-1]} black: VIO init at frame {init_f}, first-try lane (frame, label) "
        f"{lane1}, IMU_RELOC on frames {reloc[:1] + reloc[-1:]}, WORKING again at frame "
        f"{back[:1]}, last {labels[-1]}; metric ATE {ate:.5f} m over {len(sel)} frames after VIO "
        f"init (threshold {0.25 * max(span, 0.5):.5f} m = 0.25 max(span {span:.4f} m, 0.5)), "
        f"median |z error| {z_err:.5f} (bound 0.15), |bg| {bg:.5f} (bound 0.1)")
    log(f"  ms by branch (host clock to synchronize; frames 0-{b0 - 1} are phase 9's run): "
        f"{fmt_branches(by_a)}; over frames {b0}-{n - 1}: host reads "
        f"{step.host_syncs / (n - b0):.2f}/frame ({step.host_syncs} total), kernel launches "
        f"{launches_a} (expected {expect_a}), peak allocated {peak_a / 2**20:.1f} MiB")
    log(f"  states {''.join(str(s) for s in labels)} (device step)")
    if host_labels is not None:
        log(f"  states {host_labels} (phase 15, the host tracker; printed, not gated)")
    fails = []
    if not 0 <= init_f < b0:
        fails.append(f"VIO init at frame {init_f}, not before the blackout")
    if (b0, IMU_RELOC) not in lane1:
        fails.append(f"the first-try lane did not fail on frame {b0}: {lane1}")
    if not reloc:
        fails.append("IMU_RELOC never reached")
    if not back or back[0] - b0 > cfg.recovery_max_frames:
        fails.append(f"not WORKING again within {cfg.recovery_max_frames} frames")
    if labels[-1] != WORKING:
        fails.append(f"last state {labels[-1]}")
    if not ate < 0.25 * max(span, 0.5):
        fails.append(f"metric ATE {ate} >= 0.25 max(span {span}, 0.5)")
    if not z_err < 0.15:
        fails.append(f"median |z error| {z_err} >= 0.15")
    if not bg < 0.1:
        fails.append(f"|bg| {bg} >= 0.1")
    if min(launches_a.values()) <= 0 or launches_a != expect_a:
        fails.append(f"kernel launches {launches_a}, expected {expect_a}")
    if fails:
        raise AssertionError("VIP step blackout: " + "; ".join(fails))
    mark("vip_blackout")

    # (b) blackout before VIO init, then the last keyframe's image
    st, step = build_vip_tracker(cam, vip_cam_cfg(seq.K, vio_init_min_time=1e6)[1], kf_cap=64,
                                 pt_cap=8192, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(tklt)
    labels_b, ms_b, vio_b = [], [], False
    nb = PREINIT_FRAMES + len(PREINIT_BLACK)
    for b in blacked(torch, bundles[:nb], PREINIT_BLACK):
        t1 = time.perf_counter()
        st, out = step(st, b)
        torch.cuda.synchronize()
        ms_b.append((time.perf_counter() - t1) * 1e3)
        labels_b.append(int(out.state))
        vio_b |= bool(out.vio_ok)
    k = int(st.map.n_kf) - 1
    kf_frame = int(st.map.kf_frame_id[k])
    for f in range(nb, nb + 3):
        t1 = time.perf_counter()
        st, out = step(st, dataclasses.replace(bundles[f], img=bundles[kf_frame].img))
        torch.cuda.synchronize()
        ms_b.append((time.perf_counter() - t1) * 1e3)
        labels_b.append(int(out.state))
        if labels_b[-1] == WORKING:
            break
    launches_b = read_launches(tklt)
    peak_b = torch.cuda.max_memory_allocated()
    expect_b = expected_launches_vip(labels_b, n_levels)
    C_kf = st.map.kf_ns.p[int(st.map.n_kf) - 1].double().cpu().numpy()
    err_b = float(np.linalg.norm(centres(torch, np, [out.Rcw], [out.tcw])[0] - C_kf))
    n_rec = len(labels_b) - nb
    names_b = vip_branches(labels_b, [False] * len(labels_b), [False] * len(labels_b), [])
    by_b = ms_by_branch(names_b, ms_b)
    log(f"phase VIP step rare branches (b) 512x640, vio_init_min_time 1e6: WORKING "
        f"{labels_b[PREINIT_FRAMES - 1] == WORKING} after {PREINIT_FRAMES} frames, state "
        f"{labels_b[nb - 1]} after frames {PREINIT_BLACK[0]}-{PREINIT_BLACK[-1]} black, "
        f"{labels_b[-1]} on the {n_rec}. frame of keyframe {kf_frame}'s image, camera centre "
        f"{err_b:.4f} from that keyframe's (bound 0.15); ms by branch {fmt_branches(by_b)}; "
        f"host reads {step.host_syncs / len(labels_b):.2f}/frame, kernel launches {launches_b} "
        f"(expected {expect_b}), peak allocated {peak_b / 2**20:.1f} MiB")
    log(f"  states {''.join(str(s) for s in labels_b)}")
    fails = []
    if labels_b[PREINIT_FRAMES - 1] != WORKING or vio_b:
        fails.append(f"not WORKING in the mono phase before the blackout (VIO {vio_b})")
    if labels_b[nb - 1] != LOST:
        fails.append(f"state {labels_b[nb - 1]} after the black frames, not LOST")
    if labels_b[-1] != WORKING:
        fails.append("no relocalization within three frames")
    if not err_b < 0.15:
        fails.append(f"relocalized centre {err_b} from the keyframe's")
    if min(launches_b.values()) <= 0 or launches_b != expect_b:
        fails.append(f"kernel launches {launches_b}, expected {expect_b}")
    if fails:
        raise AssertionError("VIP step pre-init blackout: " + "; ".join(fails))
    mark("vip_preinit_blackout")

    # (c) the first-try lane holding: lane 0's inliers forced to zero for
    # one frame, as tests/test_torch_vip.py::test_first_try_lane_forces_a_keyframe
    f_c = FIRST_TRY_AFTER + 1
    if labels[FIRST_TRY_AFTER] != WORKING or not run["vios"][FIRST_TRY_AFTER]:
        raise AssertionError(f"frame {FIRST_TRY_AFTER} of (a) is no WORKING VI frame")
    st_ft = clone_vip_state(torch, kept[FIRST_TRY_AFTER], dev)
    n_kf0 = int(st_ft.map.n_kf)
    step_c = VipStep(cam, cfg, 64, device=dev)
    calls = []
    real = device_vip._vi_track

    def lane0_fails(tracks, *a):
        out = real(tracks, *a)
        calls.append(int(out[2]))
        return out if len(calls) > 1 else out[:2] + (torch.zeros_like(out[2]),) + out[3:]

    reset_launches(tklt)
    device_vip._vi_track = lane0_fails
    try:
        with FirstTryLog(step_c) as lane1c:
            lane1c.frame = f_c
            t1 = time.perf_counter()
            st_c, out_c = step_c(st_ft, bundles[f_c])
            torch.cuda.synchronize()
            ms_c = (time.perf_counter() - t1) * 1e3
    finally:
        device_vip._vi_track = real
    launches_c = read_launches(tklt)
    expect_c = expected_launches_vip([int(out_c.state)], n_levels, prev=WORKING)
    log(f"phase VIP step rare branches (c) frame {f_c} from the state after frame "
        f"{FIRST_TRY_AFTER}, the VI solve's inliers forced to 0: inliers of the two solves "
        f"{calls} (the second on the first-try associations, gate {step_c.reloc_min}), state "
        f"{int(out_c.state)}, new_kf {int(out_c.new_kf)} (keyframes before: {n_kf0}); "
        f"{ms_c:.1f} ms, host reads {step_c.host_syncs}, kernel launches {launches_c} (expected "
        f"{expect_c})")
    fails = []
    if len(calls) != 2 or calls[1] < step_c.reloc_min or lane1c.calls != [(f_c, WORKING)]:
        fails.append(f"VI solves {calls}, first-try lane {lane1c.calls}")
    if int(out_c.state) != WORKING or int(out_c.new_kf) != n_kf0:
        fails.append(f"state {int(out_c.state)}, new_kf {int(out_c.new_kf)} (want {n_kf0})")
    if min(launches_c.values()) <= 0 or launches_c != expect_c:
        fails.append(f"kernel launches {launches_c}, expected {expect_c}")
    if fails:
        raise AssertionError("VIP step first-try lane: " + "; ".join(fails))
    del st_ft, st_c
    mark("vip_first_try")
    record = {"blackout": {"n_frames": n, "black": list(RARE_BLACK), "vio_init_frame": init_f,
                           "lane1_calls": lane1, "imu_reloc_frames": reloc,
                           "working_again_frame": back[0], "ate_metric_m": ate,
                           "ate_threshold_m": 0.25 * max(span, 0.5), "median_z_error_m": z_err,
                           "bg_norm": bg, "ms_by_branch": by_a,
                           "host_reads_per_frame": step.host_syncs / (n - b0),
                           "frames_driven": [b0, n],
                           "peak_allocated_bytes": peak_a,
                           "labels": "".join(str(s) for s in labels)},
              "preinit_blackout": {"labels": "".join(str(s) for s in labels_b),
                                   "keyframe_frame": kf_frame, "frames_to_recover": n_rec,
                                   "centre_error": err_b, "ms_by_branch": by_b,
                                   "peak_allocated_bytes": peak_b},
              "first_try": {"frame": f_c, "inliers": calls, "ms": ms_c,
                            "new_kf": int(out_c.new_kf)},
              "card": smi}
    return record, {"vip_blackout": launches_a, "vip_preinit_blackout": launches_b,
                    "vip_first_try": launches_c}, labels


def single_vip_labels(torch, step_inputs):
    """Labels of a single-stream VIP run over `step_inputs` = (cam, cfg,
    feeds), seeded as the fleets' streams of phase 19."""
    from uvipslam_torch.frontend.device_vip import build_vip_tracker

    cam, cfg, feeds = step_inputs
    st, step = build_vip_tracker(cam, cfg, kf_cap=64, pt_cap=8192, device=feeds[0].img.device)
    labels = []
    for b in feeds:
        st, out = step(st, b)
        labels.append(int(out.state))
    return labels


def fleet_rare_phase(torch, np, tklt, dev, smi, seq, singles, mono, mono_reloc):
    """Phase 19: the per-stream loops of both fleets. (a) `VipFleetStep`,
    S = 2, RARE_FRAMES frames of phase 9's sequence: stream 0 with phase
    18a's blackout, stream 1 clean; (b) `MonoFleetStep`, S = 2: stream 0
    phase 8's relocalization input, stream 1 the same frames clean. Each
    stream's generator is seeded as its single-stream run's. `singles`:
    the single-stream labels {"black": 18a's, "clean": phase 9's}, run
    here where missing; `mono` = `mono_inputs(...)`; `mono_reloc` =
    phase 8's `reloc_phase` result. Returns (the record, launches by
    path)."""
    import dataclasses

    from uvipslam_torch.core.tree import stack_streams
    from uvipslam_torch.frontend.device_tracker import MonoFleetStep, init_state
    from uvipslam_torch.frontend.device_vip import VipFleetStep, init_vip_state, make_bundles
    from uvipslam_torch.frontend.tracker import IMU_RELOC, LOST, WORKING

    cam, cfg = vip_cam_cfg(seq.K)
    n, b0 = RARE_FRAMES, RARE_BLACK[0]
    bundles = make_bundles(seq, device=dev)[:n]
    feeds = [blacked(torch, bundles, RARE_BLACK), bundles]
    singles = dict(singles)
    for key, i in (("black", 0), ("clean", 1)):
        if singles.get(key) is None:
            singles[key] = single_vip_labels(torch, (cam, cfg, feeds[i]))
        singles[key] = [int(x) for x in singles[key][:n]]

    # (a) the VIP fleet
    fleet = VipFleetStep(cam, cfg, 64, device=dev)
    st0 = init_vip_state(cfg, 64, 8192, cam.height, cam.width, device=dev)
    st = stack_streams([dataclasses.replace(st0, gen=None)] * 2)
    del st0
    gens = seeded_generators(torch, dev, 2)
    states, anchored, ms = [[], []], [[], []], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(tklt)
    for f in range(n):
        for i, a in enumerate((st.rec_frame >= 0).tolist()):
            anchored[i].append(bool(a))
        b = stack_streams([feeds[0][f], feeds[1][f]])
        t1 = time.perf_counter()
        st, out = fleet(st, b, gens)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        for i, s in enumerate(out.state.tolist()):
            states[i].append(s)
    launches_a = read_launches(tklt)
    peak_a = torch.cuda.max_memory_allocated()
    expect_a = expected_launches_fleet(states, orb_levels(*seq.images.shape[1:]), vip=True,
                                       anchored=anchored)
    reloc = [f for f, s in enumerate(states[0]) if s == IMU_RELOC]
    back = [f for f in range(reloc[0], n) if states[0][f] == WORKING] if reloc else []
    agree = [sum(a == b for a, b in zip(states[i], singles[k])) for i, k in
             enumerate(("black", "clean"))]
    differ = [[f for f in range(n) if states[i][f] != singles[k][f]]
              for i, k in enumerate(("black", "clean"))]
    start0 = [None] + states[0][:-1]      # the state stream 0 starts each frame in
    in_reloc = [m for m, p in zip(ms, start0) if p == IMU_RELOC]
    rest = [m for f, (m, p) in enumerate(zip(ms, start0)) if f >= 3 and p != IMU_RELOC]
    reads_a = fleet.host_syncs
    log(f"phase VIP fleet rare branches (a) S 2 512x640 / 400 tracks / {n} frames, stream 0 "
        f"with frames {b0}-{RARE_BLACK[-1]} black, stream 1 clean: stream 0 IMU_RELOC on frames "
        f"{reloc[:1] + reloc[-1:]}, WORKING again at {back[:1]}; stream 1 IMU_RELOC on "
        f"{sum(s == IMU_RELOC for s in states[1])} frames; labels equal to the single-stream "
        f"runs' on {agree[0]}/{n} and {agree[1]}/{n} frames (differing frames {differ[0]} and "
        f"{differ[1]}); median {statistics.median(rest):.1f} ms per batched frame (frames 3 on, "
        f"stream 0 not in IMU_RELOC), {statistics.median(in_reloc) if in_reloc else float('nan'):.1f} "
        f"ms with stream 0 in IMU_RELOC ({len(in_reloc)} frames); host reads "
        f"{reads_a / n:.2f} per batched frame ({fleet.fleet_syncs} fleet tables), kernel "
        f"launches {launches_a} (expected {expect_a}), peak allocated {peak_a / 2**20:.1f} MiB")
    for i in range(2):
        log(f"  stream {i} states {''.join(str(s) for s in states[i])}")
    fails = []
    if not reloc or IMU_RELOC in states[1]:
        fails.append("IMU_RELOC not on stream 0 alone")
    if not back or back[0] - b0 > cfg.recovery_max_frames:
        fails.append(f"stream 0 not WORKING again within {cfg.recovery_max_frames} frames")
    if min(agree) < 0.95 * n:
        fails.append(f"labels equal to the single-stream runs' on {agree} of {n} frames")
    if min(launches_a.values()) <= 0 or launches_a != expect_a:
        fails.append(f"kernel launches {launches_a}, expected {expect_a}")
    if fails:
        raise AssertionError("VIP fleet rare branches: " + "; ".join(fails))
    del st, fleet, feeds, bundles
    mark("fleet_vip_blackout")

    # (b) the mono fleet
    _, cam_m, cfg_m, imgs = mono
    _, _, _, _, kf_frame, single = mono_reloc
    nw = RELOC_WARMUP
    T = nw + 6
    black = torch.zeros_like(imgs[0])
    frames = [[imgs[f] for f in range(nw)] + [black] * 3 + [imgs[kf_frame]] * 3,
              [imgs[f] for f in range(T)]]
    fleet = MonoFleetStep(cam_m, cfg_m, device=dev)
    st0 = init_state(cfg_m, 64, 8192, cam_m.height, cam_m.width, device=dev)
    st = stack_streams([dataclasses.replace(st0, gen=None)] * 2)
    del st0
    gens = seeded_generators(torch, dev, 2)
    states_m, ms_m, pose0 = [[], []], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(tklt)
    for f in range(T):
        x = torch.stack([frames[0][f], frames[1][f]])
        t1 = time.perf_counter()
        st, out = fleet(st, x, gens)
        torch.cuda.synchronize()
        ms_m.append((time.perf_counter() - t1) * 1e3)
        for i, s in enumerate(out.state.tolist()):
            states_m[i].append(s)
        pose0.append((out.Rcw[0], out.tcw[0]))
    launches_m = read_launches(tklt)
    peak_m = torch.cuda.max_memory_allocated()
    expect_m = expected_launches_fleet(states_m, orb_levels(*imgs.shape[1:]), vip=False)
    rec = [f for f in range(nw + 3, T) if states_m[0][f] == WORKING]
    n_rec = rec[0] - (nw + 2) if rec else None
    # the keyframe whose image stream 0 was given, in stream 0's map
    slot = (st.map.kf_frame_id[0] == kf_frame) & st.map.kf_valid[0]
    err_m = float("nan")
    if rec and bool(slot.any()):
        C_kf = st.map.kf_ns.p[0][slot][0].double().cpu().numpy()
        err_m = float(np.linalg.norm(centres(torch, np, *([x] for x in pose0[rec[0]]))[0]
                                     - C_kf))
    same = states_m[0][:len(single)] == single
    log(f"phase mono fleet rare branches (b) S 2 512x640 / 400 tracks / {T} frames, stream 0 "
        f"black on frames {nw}-{nw + 2} then keyframe {kf_frame}'s image (phase 8's), stream 1 "
        f"clean: stream 0 {states_m[0][nw + 2]} after the black frames, WORKING on the "
        f"{n_rec}. frame of the keyframe's image, camera centre {err_m:.4f} from that "
        f"keyframe's in stream 0's map (bound 0.15); "
        f"labels equal to phase 8's over its {len(single)} frames: {same}; median "
        f"{statistics.median(ms_m[3:]):.1f} ms per batched frame, host reads "
        f"{fleet.host_syncs / T:.2f} per batched frame, kernel launches {launches_m} (expected "
        f"{expect_m}), peak allocated {peak_m / 2**20:.1f} MiB")
    for i in range(2):
        log(f"  stream {i} states {''.join(str(s) for s in states_m[i])}")
    fails = []
    if states_m[0][nw + 2] != LOST or not rec or n_rec > 3:
        fails.append("stream 0 not LOST after the black frames and WORKING within three frames")
    elif not err_m < 0.15:
        fails.append(f"relocalized centre {err_m} from the keyframe's")
    if not same:
        fails.append(f"stream 0's labels differ from phase 8's {single}")
    if min(launches_m.values()) <= 0 or launches_m != expect_m:
        fails.append(f"kernel launches {launches_m}, expected {expect_m}")
    if fails:
        raise AssertionError("mono fleet rare branches: " + "; ".join(fails))
    mark("fleet_mono_reloc")
    record = {"vip": {"streams": 2, "n_frames": n, "imu_reloc_frames": reloc,
                      "working_again_frame": back[0], "labels_equal_to_single": agree,
                      "differing_frames": differ,
                      "median_ms_per_batched_frame": statistics.median(rest),
                      "median_ms_stream0_in_imu_reloc": statistics.median(in_reloc)
                      if in_reloc else None,
                      "host_reads_per_batched_frame": reads_a / n,
                      "peak_allocated_bytes": peak_a,
                      "labels": ["".join(str(s) for s in x) for x in states]},
              "mono": {"streams": 2, "n_frames": T, "frames_to_recover": n_rec,
                       "centre_error": err_m, "labels_equal_to_phase8": same,
                       "median_ms_per_batched_frame": statistics.median(ms_m[3:]),
                       "host_reads_per_batched_frame": fleet.host_syncs / T,
                       "peak_allocated_bytes": peak_m,
                       "labels": ["".join(str(s) for s in x) for x in states_m]},
              "card": smi}
    return record, {"fleet_vip_blackout": launches_a, "fleet_mono_reloc": launches_m}


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

    # the sequences render in worker processes from here on, beside the
    # build and the phases that come before each is needed
    renders = Renders()
    try:
        return run_phases(torch, np, dev, smi, renders)
    finally:
        renders.shutdown()


def run_phases(torch, np, dev, smi, renders) -> int:
    """Phases 2-19 and the result lines."""
    import uvipslam_torch  # noqa: F401  (turns TF32 off)
    from uvipslam_torch import kernels
    from uvipslam_torch.frontend.device_tracker import build_tracker
    from uvipslam_torch.ops import klt as tklt

    only = sys.argv[sys.argv.index("--only") + 1].split(",") if "--only" in sys.argv else None
    if only is None:
        # in the order the phases take them (about 45 s with four workers:
        # phases 2-8 run beside them, phase 9's timed run after them all)
        renders.submit("mono", "vip", "stream_mono", "stream_vip", *FLEET_VIP_SEQS,
                       *FLEET_MONO_SEQS)
    else:
        renders.submit(*[n for names, need in (
            (("stream_mono",), {"stream"}), (("stream_vip",), {"vip_stream"}),
            (FLEET_VIP_SEQS, {"fleet_vip", "shard"}), (FLEET_MONO_SEQS, {"fleet_mono"}),
            (("vip",), {"app", "host_vip", "frontend_ops", "vip_rare", "fleet_rare"}),
            (("mono",), {"fleet_rare"})) if need & set(only) for n in names])

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

    if only is not None:
        # development aid: the stream, fleet or app phases alone; prints no result line
        fleet_outs = None
        if "stream" in only:
            stream_mono_phase(torch, np, tklt, dev, smi, renders.get("stream_mono"))
        if "vip_stream" in only:
            stream_vip_phase(torch, np, tklt, dev, smi, renders.get("stream_vip"))
        if "fleet_kernels" in only:
            batched_kernel_phase(torch, tklt, dev)
        if "fleet_vip" in only:
            _, _, fleet_outs = fleet_vip_phase(torch, np, tklt, dev, smi, None,
                                               [renders.get(n) for n in FLEET_VIP_SEQS])
        if "fleet_mono" in only:
            fleet_mono_phase(torch, np, tklt, dev, smi, None,
                             [renders.get(n) for n in FLEET_MONO_SEQS])
        if {"app", "host_vip", "frontend_ops"} & set(only):
            seq = renders.get("vip")
            if "app" in only:
                app_phase(torch, np, tklt, dev, smi, seq, None)
            if "host_vip" in only:
                host_vip_blackout_phase(torch, np, tklt, dev, smi, seq)
            if "frontend_ops" in only:
                frontend_ops_phase(torch, np, tklt, dev, smi, seq)
        if "shard" in only:
            shard_phase(torch, np, smi, [renders.get(n) for n in FLEET_VIP_SEQS[:SHARD_STREAMS]],
                        fleet_outs)
        if {"vip_rare", "fleet_rare"} & set(only):
            vseq = renders.get("vip")
            rare_labels = None
            if "vip_rare" in only:
                _, _, rare_labels = vip_rare_phase(torch, np, tklt, dev, smi, vseq)
            if "fleet_rare" in only:
                mono = mono_inputs(torch, np, dev, renders.get("mono"))
                _, cam_m, cfg_m, imgs_m = mono
                reloc = reloc_phase(torch, np, tklt, lambda: build_tracker(
                    cam_m, cfg_m, kf_cap=64, pt_cap=8192, device=dev), imgs_m)
                fleet_rare_phase(torch, np, tklt, dev, smi, vseq, {"black": rare_labels}, mono,
                                 reloc)
        log("phase end times (s since start): " + ", ".join(f"{k} {v}" for k, v in MARKS.items()))
        log("partial run (--only): no result line")
        return 0

    # -- phase 3: kernels vs plain ---------------------------------------
    log("phase kernel-vs-plain: extract_patches (exact equality)")
    patch_err, patch_rows = patch_phase(torch, tklt, dev)
    log("phase kernel-vs-plain: anchor_refine (1e-3 px where both accept)")
    refine_err, refine_rows = refine_phase(torch, tklt, dev)
    log(f"phase kernel-vs-plain: both kernels over {FLEET_S} streams in one launch")
    fleet_patch_rows, fleet_refine_rows, fleet_refine_err = batched_kernel_phase(torch, tklt, dev)
    refine_err = max(refine_err, fleet_refine_err)
    mark("kernel_vs_plain")

    # -- phase 4/5 need the synthetic sequences -------------------------
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

    mono = mono_inputs(torch, np, dev, renders.get("mono"))
    seq, cam, cfg, imgs = mono
    mark("sequence")

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
    run_meds = timed_runs(torch, new_tracker, imgs, first, MONO_REPEATS)

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
    profile = profile_phase(torch, step_a, st_a, imgs, audit_frames, PROFILE_FRAMES,
                            "profile.txt")
    mark("mono_profile")
    # device time does not depend on the profiler; the host clock does
    profile["device_idle_share"] = 1.0 - profile["device_ms_per_frame"] / med
    log(f"  device idle share at the unprofiled {med:.1f} ms/frame: "
        f"{100 * profile['device_idle_share']:.1f}%")

    # -- phase 8: mono relocalization ----------------------------------------
    mono_reloc = reloc_phase(torch, np, tklt, new_tracker, imgs)
    n_rec, rec_err, reloc_launches, reloc_expect, kf_frame, _ = mono_reloc
    mark("mono_reloc")
    log(f"phase mono relocalization: LOST after 3 black frames; WORKING again on the "
        f"{n_rec}. frame of keyframe {kf_frame}'s image, camera centre {rec_err:.4f} from the "
        f"keyframe's (bound 0.15); kernel launches {reloc_launches} from the first black frame "
        f"on (expected {reloc_expect})")

    # -- phase 9: the VIP step ------------------------------------------------
    vip_seq = renders.get("vip")
    renders.wait_all()
    mark("vip_sequence")
    vip_record, vip_launches, rare_prefix = vip_phase(torch, np, tklt, dev, smi, vip_seq)

    # -- phases 10 and 11: the streams with loop closing -----------------------
    stream_record, stream_launches = stream_mono_phase(torch, np, tklt, dev, smi,
                                                       renders.get("stream_mono"))
    vstream_record, vstream_launches = stream_vip_phase(torch, np, tklt, dev, smi,
                                                        renders.get("stream_vip"))

    # -- phases 12 and 13: batched replay ----------------------------------------
    fleet_seqs = [renders.get(n) for n in FLEET_VIP_SEQS]
    fleet_record, fleet_launches, fleet_outs = fleet_vip_phase(torch, np, tklt, dev, smi,
                                                               vip_record, fleet_seqs)
    mfleet_record, mfleet_launches = fleet_mono_phase(torch, np, tklt, dev, smi, med,
                                                     [renders.get(n) for n in FLEET_MONO_SEQS])

    # -- phase 14: the application entry point from a bag ------------------------
    app_record, app_launches = app_phase(torch, np, tklt, dev, smi, vip_seq, vip_record)

    # -- phase 15: the host VIP tracker through a blackout ----------------------
    blackout_record, blackout_launches = host_vip_blackout_phase(torch, np, tklt, dev, smi,
                                                                 vip_seq)

    # -- phase 16: the steered frontend ------------------------------------------
    fops_record, fops_launches = frontend_ops_phase(torch, np, tklt, dev, smi, vip_seq)

    # -- phase 17: the VIP fleet sharded over processes ---------------------------
    shard_record, shard_launches = shard_phase(torch, np, smi,
                                               fleet_seqs[:SHARD_STREAMS], fleet_outs)

    # -- phases 18 and 19: the rare branches of the VIP step and the fleets ----------
    rare_record, rare_launches, rare_labels = vip_rare_phase(torch, np, tklt, dev, smi, vip_seq,
                                                             blackout_record["labels"], rare_prefix)
    del rare_prefix
    frare_record, frare_launches = fleet_rare_phase(
        torch, np, tklt, dev, smi, vip_seq,
        {"black": rare_labels, "clean": [int(c) for c in vip_record["labels"]]}, mono, mono_reloc)

    log("phase end times (s since start): " + ", ".join(f"{k} {v}" for k, v in MARKS.items()))
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "uvipslam_tpu"))
    if foreign:
        raise AssertionError(f"the reference stack was imported: {foreign[:5]}")

    big = [r for r in patch_rows if r["psize"] == 35 and r["shape"] == [512, 640]][0]
    full = [r for r in refine_rows if r["shape"] == [512, 640]][0]
    by_path = {"vip": vip_launches, "mono": launches, "mono_reloc": reloc_launches,
               "stream_mono": stream_launches, "stream_vip": vstream_launches,
               "replay_vip": fleet_launches, "replay_mono": mfleet_launches, **app_launches,
               "host_vip_blackout": blackout_launches, "frontend_steered": fops_launches,
               **shard_launches, **rare_launches, **frare_launches}
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
        "fleet_shapes": fleet_patch_rows,
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
        "fleet_shapes": fleet_refine_rows,
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
                   "vip": vip_record, "stream_mono": stream_record,
                   "stream_vip": vstream_record, "replay_vip": fleet_record,
                   "replay_mono": mfleet_record, "app": app_record,
                   "host_vip_blackout": blackout_record, "frontend_ops": fops_record,
                   "shard": shard_record, "vip_rare": rare_record, "fleet_rare": frare_record,
                   "phase_end_s": MARKS}
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
