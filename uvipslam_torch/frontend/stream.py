"""Streaming host wrapper for the device trackers with loop closing.

Counterpart of `uvipslam_tpu/frontend/stream.py`. Frames arrive one at a
time; after each device step the wrapper reads the step's `new_kf` hook
(one scalar, one host read per frame) and, on a keyframe frame, runs the
`LoopCloser` pass on the device map. On a closure the corrected map is
pushed back into the step's state together with the re-anchored pose,
a reset motion model and, in VIP mode, the corrected NavState and a
fresh frame-to-frame prior.

Spans for a profiler: `stream.process` around a frame, and the closer's
`loop.detect`, `loop.sim3`, `loop.essential_graph`, `loop.fuse`,
`loop.global_ba`.
"""

from __future__ import annotations

import dataclasses
import time

import torch
from torch.profiler import record_function

from uvipslam_torch.core.tree import tree_map
from uvipslam_torch.frontend.device_tracker import step_device
from uvipslam_torch.frontend.tracker import _ns_to_cam_pose, _ns_to_cam_pose_ext
from uvipslam_torch.models.camera import CameraModel

MONO, VIP = "mono", "vip"


class DeviceStream:
    """Per-frame streaming around a device tracker + loop closing, on the
    card unless `device` names another.

    >>> ds = DeviceStream(cam, cfg, mode="vip")
    >>> for bundle in bundles: out = ds.process(bundle)

    `host_syncs` counts the wrapper's own reads of `new_kf` and `vio_ok`
    (the step counts its own in `step.host_syncs`, the closer in
    `loop_closer.host_reads`); `kf_passes` lists, per keyframe pass, the
    frame, the slot, the closer's status, its milliseconds by part and
    its host reads."""

    def __init__(self, cam: CameraModel, cfg, kf_cap: int = 128, pt_cap: int = 8192,
                 mode: str = VIP, device="cuda", seed: int = 0):
        self.cam = cam
        self.cfg = cfg
        self.mode = mode
        self.device = dev = step_device(device)
        f32 = dict(dtype=torch.float32, device=dev)
        self.eye3, self.zero3 = torch.eye(3, **f32), torch.zeros(3, **f32)
        if mode == VIP:
            from uvipslam_torch.frontend.device_vip import build_vip_tracker
            self.st, self.step = build_vip_tracker(cam, cfg, kf_cap, pt_cap, device=dev,
                                                   seed=seed)
            self.Rbc, self.tbc = self.step.Rbc, self.step.tbc
            self.Rcb, self.tcb = self.step.Rcb, self.step.tcb
        else:
            from uvipslam_torch.frontend.device_tracker import build_tracker
            self.st, self.step = build_tracker(cam, cfg, kf_cap, pt_cap, device=dev, seed=seed)
            self.Rbc = self.Rcb = self.eye3
            self.tbc = self.tcb = self.zero3
        self.sigmas = torch.tensor(cfg.scale_sigmas, dtype=torch.float32).to(dev)
        self.loop_closer = None
        if getattr(cfg, "loop_closing", False):
            from uvipslam_torch.loop.closer import LoopCloser
            mt = getattr(cfg, "loop_min_total_matches", -1)
            self.loop_closer = LoopCloser(
                cam.fx, cam.fy, cam.cx, cam.cy,
                min_sim3_inliers=getattr(cfg, "loop_min_sim3_inliers", 20),
                min_total_matches=None if mt < 0 else mt, device=dev)
        self.loop_events: list[tuple[int, int]] = []
        self.kf_passes: list[dict] = []
        self.frame_id = -1
        self.host_syncs = 0

    # ------------------------------------------------------------------
    def process(self, x):
        """Feed one frame (image for mono, FrameBundle for VIP). Returns
        the device StepOut / VipStepOut."""
        self.frame_id += 1
        with record_function("stream.process"):
            self.st, out = self.step(self.st, x)
            self.host_syncs += 1
            k = int(out.new_kf)
            if self.loop_closer is not None and k >= 0:
                self._close_loop_at(k)
        return out

    # ------------------------------------------------------------------
    def _post_ba(self, vio_ok: bool):
        from uvipslam_torch.solver.global_ba import global_ba_navstate, global_ba_visual

        cam, cfg = self.cam, self.cfg
        if vio_ok:
            return lambda m: global_ba_navstate(
                m, self.step.gravity, self.Rcb, self.tcb, cam.fx, cam.fy, cam.cx, cam.cy,
                cfg.gyr_noise_sd, cfg.acc_noise_sd, cfg.gyr_bias_rw2, cfg.acc_bias_rw2,
                self.step.depth_info, self.sigmas)
        return lambda m: global_ba_visual(m, cam.fx, cam.fy, cam.cx, cam.cy, self.sigmas)

    def _close_loop_at(self, kf_slot: int):
        """Host loop-closing pass at a keyframe boundary; on a closure the
        corrected map and the device pose / filter state are pushed back."""
        lc = self.loop_closer
        st = self.st
        vio_ok = False
        if hasattr(st, "vio_ok"):
            self.host_syncs += 1
            vio_ok = bool(st.vio_ok)
        if vio_ok:
            lc.Rcb, lc.tcb, lc.Rbc, lc.tbc = self.Rcb, self.tcb, self.Rbc, self.tbc
        else:
            lc.Rcb, lc.tcb, lc.Rbc, lc.tbc = self.eye3, self.zero3, self.eye3, self.zero3
        lc.post_ba = self._post_ba(vio_ok)

        t0 = time.perf_counter()
        m2, stat = lc.process_keyframe(st.map, kf_slot)
        self.kf_passes.append(dict(frame=self.frame_id, kf=kf_slot, status=stat,
                                   ms=(time.perf_counter() - t0) * 1e3,
                                   parts_ms=dict(lc.last_timing), host_reads=lc.last_reads))
        if not stat.get("loop"):
            return
        # push the corrected map back and re-anchor the device pose and
        # (after VIO init) the VI filter at the corrected keyframe
        ns_k = tree_map(lambda a: a[kf_slot], m2.kf_ns)
        if vio_ok:
            Rcw, tcw = _ns_to_cam_pose_ext(ns_k, self.Rcb, self.tcb)
        else:
            Rcw, tcw = _ns_to_cam_pose(ns_k)
        updates = dict(map=m2, Rcw=Rcw, tcw=tcw, R_vel=self.eye3.clone(),
                       t_vel=self.zero3.clone())
        if hasattr(st, "ns"):
            updates["ns"] = ns_k if vio_ok else st.ns
        if hasattr(st, "H_prior"):
            updates["H_prior"] = torch.eye(15, dtype=torch.float32, device=self.device) * 1e2
        self.st = dataclasses.replace(st, **updates)
        self.loop_events.append((self.frame_id, int(stat["loop_kf"])))
