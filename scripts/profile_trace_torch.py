"""Profile of the port's device steps by phase span and by kernel.

`scripts/profile_trace.py` rebuilt on `torch.profiler`: the mono device
step (or the VIP step with `--vip`) runs over a synthetic sequence at the
bench's settings (512x640, 400 tracks, kf_cap 64, pt_cap 8192, seed 7),
then the last `--window` frames run under the profiler. Printed per
frame: time inside each `step.*` / `loop.*` span (host, and on the card
the device time of the kernels it launched), device time by kernel, and
kernel launches; the full operator tables go to `--out`.

    python scripts/profile_trace_torch.py [--vip] [--frames 60] [--window 2]
    python scripts/profile_trace_torch.py --device cpu --frames 3 --size 64 80

On the card the run fails if the profiler sees no device time. A CPU run
(`--device cpu`) has no device: it reports host time only and says so.
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

SPANS = ("step.", "loop.")


def build(args, device):
    """(state, step, per-frame inputs) of the chosen step."""
    from uvipslam_torch.io.synthetic import make_sequence
    from uvipslam_torch.models.camera import CameraModel

    H, W = args.size
    seq = make_sequence(n_frames=args.frames, H=H, W=W, n_points=6000, seed=7, speed=1.2)
    cam = CameraModel.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], width=W,
                             height=H)
    if args.vip:
        from uvipslam_torch.frontend.device_vip import build_vip_tracker, make_bundles
        from uvipslam_torch.frontend.vip_tracker import VipConfig
        cfg = VipConfig(n_tracks=400, min_init_tracks=100, local_window=8, vio_init_min_kfs=6,
                        vio_init_min_time=1.0)
        st, step = build_vip_tracker(cam, cfg, kf_cap=64, pt_cap=8192, device=device)
        return st, step, make_bundles(seq, device=device)
    from uvipslam_torch.frontend.device_tracker import build_tracker
    from uvipslam_torch.frontend.tracker import TrackerConfig
    cfg = TrackerConfig(n_tracks=400, min_init_tracks=100, local_window=8)
    st, step = build_tracker(cam, cfg, kf_cap=64, pt_cap=8192, device=device)
    return st, step, torch.from_numpy(seq.images.astype(np.float32)).to(device)


def profile(step, st, feeds, start, n, cuda: bool):
    """torch.profiler over frames start..start+n-1; returns the profiler's
    averages and the wall ms per frame under it."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with tprofile(activities=acts) as prof:
        t0 = time.perf_counter()
        for f in range(start, start + n):
            st, _ = step(st, feeds[f])
        sync()
        wall = (time.perf_counter() - t0) * 1e3 / n
    return prof.key_averages(), wall


def report(ev, n, wall_ms, cuda: bool, out: str) -> dict:
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    def dev_total_us(e):
        return getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))

    spans = {e.key: (e.cpu_time_total / 1e3 / n, dev_total_us(e) / 1e3 / n, e.count / n)
             for e in ev if e.key.startswith(SPANS) and e.device_type == DeviceType.CPU}
    kernels = sorted((e for e in ev if e.device_type == DeviceType.CUDA
                      and not e.key.startswith(SPANS)), key=dev_us, reverse=True)
    device_ms = sum(dev_us(e) for e in kernels) / 1e3 / n
    launches = sum(e.count for e in ev if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                    "cudaLaunchKernelExC")) / n
    print(f"wall under the profiler {wall_ms:.2f} ms/frame; "
          + (f"device busy {device_ms:.3f} ms/frame, {launches:.0f} kernel launches/frame"
             if cuda else "no device in a CPU run"))
    print("=== by span (host ms/frame | device ms/frame | calls/frame)" if cuda else
          "=== by span (host ms/frame | calls/frame; device time not measured: CPU run)")
    for k, (h, d, c) in sorted(spans.items(), key=lambda kv: -kv[1][0]):
        print(f"{h:10.2f} | {d:10.3f} | {c:5.2f}  {k}" if cuda else f"{h:10.2f} | {c:5.2f}  {k}")
    if cuda:
        print("=== device time by kernel (ms/frame, launches/frame)")
        for e in kernels[:25]:
            print(f"{dev_us(e) / 1e3 / n:10.3f}  x{e.count / n:7.1f}  {e.key[:100]}")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as fh:
        if cuda:
            fh.write(ev.table(sort_by="self_cuda_time_total", row_limit=80) + "\n\n")
        fh.write(ev.table(sort_by="self_cpu_time_total", row_limit=60))
    print(f"tables: {out}")
    if cuda and device_ms <= 0:
        raise RuntimeError("the profiler saw no device time")
    return {"spans": spans, "device_ms_per_frame": device_ms if cuda else None,
            "launches_per_frame": launches if cuda else None}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--vip", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--window", type=int, default=2, help="profiled frames at the end")
    ap.add_argument("--size", type=int, nargs=2, default=(512, 640), metavar=("H", "W"))
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "profile_trace_torch.txt"))
    args = ap.parse_args(argv)

    import uvipslam_torch  # noqa: F401  (turns TF32 off)
    from uvipslam_torch.frontend.tracker import step_device

    device = step_device(args.device)
    cuda = device.type == "cuda"
    if cuda:
        from uvipslam_torch import kernels
        kernels.load()
    st, step, feeds = build(args, device)
    start = max(0, args.frames - args.window)
    for f in range(start):
        st, _ = step(st, feeds[f])
    ev, wall = profile(step, st, feeds, start, args.frames - start, cuda)
    print(("VIP" if args.vip else "mono") + f" step on {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if cuda else "")
          + f", {args.size[0]}x{args.size[1]}, frames {start}-{args.frames - 1} profiled")
    return report(ev, args.frames - start, wall, cuda, args.out)


if __name__ == "__main__":
    main()
