"""The port's application entry point: settings, sensor input, the tracker of
the configured mode, the trajectory export, the FPS line and the ATE.

Counterpart of `uvipslam_tpu/app.py`, with its command line:

  python -m uvipslam_torch.app --settings Data/xxx.yaml [--bag file.bag] \
      [--gt stamped_groundtruth.txt] [--device]
  python -m uvipslam_torch.app --synthetic 120 --mode 2 --device

It loads the settings YAML, decodes the rosbag (or renders a synthetic
sequence), runs every frame through the tracker of the configured mode,
writes the final map's keyframe trajectory in TUM format, prints the
frames, keyframes and FPS, and with `--gt` evaluates the rpg-style ATE
(`sim3` alignment for MONO, `posyaw` for VI/VIP unless `--align` names
another) and returns its result.

`--device` runs the device steps one frame at a time: MONO through
`frontend.device_tracker.build_tracker`, VI and VIP through
`frontend.device_vip.build_vip_tracker`, every frame's input uploaded
once before the clock starts, the per-frame outputs read once after the
run. On the card the hand kernels are built and loaded before the clock
starts in every branch (there is no compile pass to time apart); the
build's seconds go into the `device_replay` metrics event. As in the reference, the
`--device` branch runs no loop closer (`LoopC` is read by the host
branch only). Without `--device`, MONO runs the host `MonoTracker` and
VI/VIP the host `VipTracker` (`frontend/vip_tracker.py`), one
`process_frame` / `process_frame_vip` call per frame with the images and
IMU windows uploaded before the clock starts (depth, its flag and the
timestamp stay host values); `LoopC` switches their loop closer on. The
`run_end` metrics event carries the run's host reads in every branch.

`main(argv, device="cuda")` runs on the card unless the caller names
another device (the tests pass "cpu"); it raises when there is no card.
"""

from __future__ import annotations

import argparse
import os
import time
import types

import numpy as np
import torch


def _np(x, dtype=None):
    """A tensor (any device) or an array as numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def _kf_trajectory(m, vio_ok: bool, Tbc, timestamps):
    """The final map's keyframe trajectory as (timestamps, Rcw, tcw), in
    keyframe frame order. Once VIO is up the keyframe table stores BODY
    NavStates and the camera pose follows through Tbc (Rwc = Rwb Rbc,
    C = p + Rwb tbc); before (and in MONO) it stores the camera as the
    body. The frame id indexes the sequence's timestamps in every mode."""
    timestamps = np.asarray(timestamps, np.float64)
    frames = _np(m.kf_frame_id)
    kf_valid = _np(m.kf_valid) & (frames >= 0) & (frames < len(timestamps))
    times = np.where(kf_valid, timestamps[np.clip(frames, 0, len(timestamps) - 1)], 0.0)
    p = _np(m.kf_ns.p, np.float64)
    R = _np(m.kf_ns.R, np.float64)
    Tbc = np.asarray(Tbc, np.float64)
    Rbc, tbc = Tbc[:3, :3], Tbc[:3, 3]
    idx = np.nonzero(kf_valid)[0][np.argsort(frames[kf_valid])]
    ts, Rs, tvs = [], [], []
    for k in idx:
        if vio_ok:
            Rwc, C = R[k] @ Rbc, p[k] + R[k] @ tbc
        else:
            Rwc, C = R[k], p[k]
        ts.append(times[k])
        Rs.append(Rwc.T)
        tvs.append(-Rwc.T @ C)
    return ts, Rs, tvs


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser(prog="python -m uvipslam_torch.app")
    ap.add_argument("--settings", help="reference-schema YAML settings file")
    ap.add_argument("--bag", help="rosbag path (overrides settings bagfile)")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="run N synthetic frames instead of a bag")
    ap.add_argument("--mode", type=int, default=None, help="0 MONO / 1 VI / 2 VIP")
    ap.add_argument("--device", action="store_true",
                    help="run the device steps (the whole per-frame pipeline on the card, "
                         "outputs read once after the run) instead of the host tracker "
                         "(MonoTracker for MONO, VipTracker for VI/VIP)")
    ap.add_argument("--out", default="stamped_traj_estimate.txt")
    ap.add_argument("--gt", default=None,
                    help="stamped_groundtruth.txt (TUM): runs the rpg-style ATE evaluation "
                         "after the replay")
    ap.add_argument("--align", default=None, choices=["sim3", "se3", "posyaw", "none"],
                    help="ATE alignment (default: sim3 for MONO, posyaw for VI/VIP)")
    ap.add_argument("--metrics", default=None,
                    help="write a structured JSONL metrics stream here")
    args = ap.parse_args(argv)

    from uvipslam_torch.frontend.tracker import WORKING, step_device
    from uvipslam_torch.io.config import MONO, Settings, load_settings
    from uvipslam_torch.io.trajectory import save_tum_trajectory
    from uvipslam_torch.models.camera import FISHEYE, RADTAN, CameraModel
    from uvipslam_torch.utils.metrics import MetricsLogger

    device = step_device(device)
    if args.settings:
        if not os.path.exists(args.settings):
            ap.error(f"settings file not found: {args.settings}")
        s = load_settings(args.settings)
    else:
        s = Settings()
    if args.mode is not None:
        s.mode = args.mode

    if args.synthetic:
        from uvipslam_torch.io.synthetic import make_sequence
        seq = make_sequence(n_frames=args.synthetic, H=240, W=320, n_points=4000, speed=1.2,
                            z_amp=0.5, depth_noise=0.02)
        bundles = dict(images=seq.images, timestamps=seq.timestamps, imu_omg=seq.imu_omg,
                       imu_acc=seq.imu_acc, imu_dt=seq.imu_dt, imu_mask=seq.imu_mask,
                       depth=seq.depth, depth_valid=seq.depth_valid)
        cam = CameraModel.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2],
                                 width=320, height=240)
        imu_cfg = dict(gyr_noise_sd=0.01, acc_noise_sd=0.1, depth_noise_sd=0.05,
                       vio_init_min_kfs=8, vio_init_min_time=2.5)
    else:
        from uvipslam_torch.io.bag import make_frame_bundles, read_bag
        bag = read_bag(args.bag or s.bagfile, s.image_topic, s.imu_topic, s.depth_topic)
        bundles = make_frame_bundles(bag, delay_to_imu=s.delay_to_imu)
        cam = CameraModel.create(s.fx, s.fy, s.cx, s.cy, dist=(s.k1, s.k2, s.p1, s.p2),
                                 kind=FISHEYE if s.fisheye else RADTAN,
                                 width=s.width, height=s.height)
        # Camera.Tbc rides along: every VI stage consumes the extrinsics
        imu_cfg = dict(gyr_noise_sd=s.gyr_noise, acc_noise_sd=s.acc_noise,
                       gyr_bias_rw2=s.gyr_rw ** 2, acc_bias_rw2=s.acc_rw ** 2,
                       depth_noise_sd=s.depth_noise, vio_init_min_time=s.init_time,
                       init_mode=s.init_mode,
                       Tbc=tuple(map(tuple, np.asarray(s.Tbc, np.float64).tolist())))

    n_frames = len(bundles["timestamps"])
    ml = MetricsLogger(args.metrics, run_id=f"mode{s.mode}")
    # every frame's input goes to the device once, before the clock starts
    if s.mode == MONO or not args.device:
        xs = torch.from_numpy(np.asarray(bundles["images"], np.float32)).to(device)

    # on the card the hand kernels are built and loaded before any clock
    t0 = time.time()
    if device.type == "cuda":
        from uvipslam_torch import kernels
        kernels.build()
        kernels.load()
    build_s = time.time() - t0
    if args.device:
        if s.mode == MONO:
            from uvipslam_torch.frontend.device_tracker import build_tracker
            from uvipslam_torch.frontend.tracker import TrackerConfig
            cfg = TrackerConfig(n_tracks=s.n_features, px_distance=s.px_distance,
                                local_window=s.local_window_size, enhance=bool(s.enhance))
            st, step = build_tracker(cam, cfg, kf_cap=128, pt_cap=8192, device=device)
        else:
            from uvipslam_torch.frontend.device_vip import build_vip_tracker, make_bundles
            from uvipslam_torch.frontend.vip_tracker import VipConfig
            cfg = VipConfig(n_tracks=s.n_features, px_distance=s.px_distance,
                            local_window=s.local_window_size, enhance=bool(s.enhance), **imu_cfg)
            st, step = build_vip_tracker(cam, cfg, kf_cap=128, pt_cap=8192, device=device)
            xs = make_bundles(types.SimpleNamespace(**bundles), device=device)
        _sync(device)
        t1 = time.time()
        states = []
        for f in range(n_frames):
            st, out = step(st, xs[f])
            states.append(out.state)
        _sync(device)
        wall = time.time() - t1
        states = _np(torch.stack(states))
        n_tracked = int((states == WORKING).sum())
        for f in range(n_frames):
            ml.frame(f, {"state": "WORKING" if states[f] == WORKING else f"state{int(states[f])}"})
        n_kf = int(st.map.n_kf)
        ml.event("device_replay", build_s=round(build_s, 1))
        vio_ok = bool(getattr(st, "vio_ok", False))
        host_reads = step.host_syncs
    elif s.mode == MONO:
        from uvipslam_torch.frontend.tracker import MonoTracker, TrackerConfig
        cfg = TrackerConfig(n_tracks=s.n_features, px_distance=s.px_distance,
                            local_window=s.local_window_size, enhance=bool(s.enhance),
                            loop_closing=bool(s.loop_closing))
        st = MonoTracker(cam, cfg, device=device)
        t0 = time.time()
        for f in range(n_frames):
            ml.frame(f, st.process_frame(xs[f]))
        _sync(device)
        wall = time.time() - t0
        vio_ok = False
    else:
        from uvipslam_torch.frontend.vip_tracker import VipConfig, VipTracker
        cfg = VipConfig(n_tracks=s.n_features, px_distance=s.px_distance,
                        local_window=s.local_window_size, enhance=bool(s.enhance),
                        loop_closing=bool(s.loop_closing), **imu_cfg)
        st = VipTracker(cam, cfg, device=device)
        imu = [torch.from_numpy(np.asarray(bundles[k], np.float32)).to(device)
               for k in ("imu_omg", "imu_acc", "imu_dt", "imu_mask")]
        depth = np.asarray(bundles["depth"], np.float64)
        depth_valid = np.asarray(bundles["depth_valid"], bool)
        stamps = np.asarray(bundles["timestamps"], np.float64)
        _sync(device)
        t0 = time.time()
        for f in range(n_frames):
            ml.frame(f, st.process_frame_vip(xs[f], *(a[f] for a in imu), depth=float(depth[f]),
                                             depth_valid=bool(depth_valid[f]),
                                             timestamp=float(stamps[f])))
        _sync(device)
        wall = time.time() - t0
        vio_ok = st.vio_ok
    if not args.device:
        n_tracked = len(st.trajectory)
        n_kf = int(st.map.n_kf)
        host_reads = st.host_syncs
    Tbc_used = np.asarray(getattr(cfg, "Tbc", np.eye(4)))

    ml.counter("frames", n_frames)
    ml.event("run_end", fps=round(n_frames / max(wall, 1e-9), 2), n_keyframes=n_kf,
             run_s=round(wall, 4), host_reads=host_reads)
    ml.close()
    # the keyframe trajectory of the final map: consistent after the VIO
    # init's rescale and any loop closure
    ts, Rs, tvs = _kf_trajectory(st.map, vio_ok, Tbc_used, bundles["timestamps"])
    save_tum_trajectory(args.out, ts, Rs, tvs)
    print(f"frames: {n_frames}  tracked: {n_tracked}  keyframes: {len(ts)}  "
          f"FPS: {n_frames / max(wall, 1e-9):.2f}  -> {args.out}")

    if args.gt:
        import json

        from uvipslam_torch.io.evaluate import evaluate_ate
        align = args.align or ("sim3" if s.mode == MONO else "posyaw")
        res = evaluate_ate(args.out, args.gt, align=align)
        print("ATE " + json.dumps(res))
        return res


if __name__ == "__main__":
    main()
