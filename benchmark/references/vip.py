"""The VIP configuration's judge: the plain reference (`reference.py`)
against what the timed path produced, stream by stream and dive by dive.

Numbers compared, each at most its limit (the configuration's `limits`):

- `not_working_share`: the largest share of a dive's frames not tracked
  WORKING (the configuration's gate: at least 80% WORKING);
- `dives_without_vio`: dives whose VIO never came up (the gate: 0);
- `ate_span_share`: the largest metric ATE (SE3 alignment) of a dive's
  WORKING frames from VIO init + 3 on, at least 6 of them, over the
  ground truth's span (the gate: below 5%);
- `kf_ate_span_share`: the same of the keyframe poses that the windowed
  VI BA leaves in the map at the dive's end (the same gate);
- `ba_kept_chi2`: the map that the last windowed BA of the dive left,
  against the BA's own guarantee: each observation that it keeps in the
  window (the others it cuts from the map) lies in front of its camera
  and has a weighted squared reprojection error of at most 5.991 (the
  chi-square 95% bound of 2 degrees of freedom, the configuration's
  limit) at the keyframe poses and points that it leaves; the largest
  such error, by the float64 reference (`reference.obs_chi2`; inf for an
  observation behind its camera);
- `refine_gap`: the anchor refinement kernel's output: the positions of
  the tracks carried through a judged frame against the plain
  propagation (`reference.propagate`: the global shift, the refinement at
  half and full resolution) from the state the frame started from, on
  the dive's images: the 90th percentile of the distance (px; a few
  tracks, whose steps stop short of convergence, amplify float32 rounding
  to the size of the control's gaps, so the widest gap does not separate
  the two). VIP: the
  tracks with no landmark, whose start is the previous position plus the
  global shift (the others start from the IMU's prediction); mono: every
  carried track, those with a landmark starting from its projection by
  the velocity model's pose;
- `preint_dR_rad`, `preint_dV_mps`, `preint_dP_m`: the largest gaps of
  the state's preintegration since the last keyframe to the reference's
  over the dive's own raw IMU samples of those frames (rotation angle,
  velocity and position);
- `template_gap`: the largest gap (gray levels) of a track's birth
  template and gradients, made by the patch-pull kernel and the
  interpolation products, to the reference's samples of the dive's image
  at the track's position, over the tracks born in the judged frames;
- `kf_depth_gap`: the largest gap of a keyframe's pressure depth, the
  input of the VI BA's pressure factor, to the dive's depth at that frame
  (a copy: 0).

With `tf32` the reference in TF32 stands in the program's place (the
control): its preintegrations, templates, depths and propagated
positions against the float64 reference, on the same frames and tracks;
the numbers whose limit the configuration states (the tracking gates and
the BA's bound) read 0.
"""

from __future__ import annotations

import numpy as np

import reference as ref

WORKING = 2

# the state's fields the judge reads at the judged frames, and at a dive's
# end ("." walks into the state's dataclasses)
SNAP = ("frame_id", "state", "tracks.xy", "tracks.valid", "tracks.birth_frame", "tracks.tpl",
        "tracks.tpl_gx", "tracks.tpl_gy", "preint_kf.dR", "preint_kf.dV", "preint_kf.dP",
        "preint_kf.dt", "last_kf_frame")
# ... and before them: the tracks the frame starts from
PRE = ("tracks.xy", "tracks.valid", "tracks.pt_id", "tracks.tpl", "tracks.tpl_gx",
       "tracks.tpl_gy", "tracks.tpl2", "tracks.tpl2_gx", "tracks.tpl2_gy")
END = ("map.kf_valid", "map.kf_frame_id", "map.kf_ns.p", "map.kf_ns.R", "map.kf_depth",
       "map.kf_depth_valid", "map.kf_feat_xy", "map.kf_feat_pt", "map.kf_feat_valid",
       "map.kf_feat_level", "map.pt_xyz", "map.pt_valid", "map.n_kf")
INF = float("inf")
W_KF_BA = 12                                   # the window BA's keyframe slots
SCALE_SIGMAS = 1.2 ** (2 * np.arange(8))       # sigma^2 of a feature by pyramid level


def span(dive) -> float:
    pos = dive.positions_w
    return float(np.linalg.norm(pos[-1] - pos[0]))


def frame_ate(rec, vio: bool) -> float:
    """ATE over the span of the dive's WORKING frames (VIP: from VIO init
    + 3 on, metric; mono: Sim3)."""
    st = rec["state"]
    working = st == WORKING
    R, t = rec["Rcw"], rec["tcw"]
    centres = -np.einsum("nji,nj->ni", R, t)
    if vio:
        v = rec["vio"]
        if not v.any():
            return INF
        init_f = int(np.argmax(v))
        sel = [i for i in range(len(st)) if i >= init_f + 3 and working[i]]
    else:
        sel = list(np.flatnonzero(working))
    if len(sel) <= 5:
        return INF
    return ref.ate(centres[sel], rec["dive"].positions_w[sel], scale=not vio) / span(rec["dive"])


def kf_ate(rec, vio: bool) -> float:
    end = rec["end"]
    ok = end["map.kf_valid"]
    if ok.sum() < 3:
        return INF
    fid = end["map.kf_frame_id"][ok]
    return ref.ate(end["map.kf_ns.p"][ok], rec["dive"].positions_w[fid], scale=not vio) \
        / span(rec["dive"])


def ba_window(rec, vio: bool):
    """The last windowed BA's observations as the map at the dive's end
    holds them: the window's cameras (Rcw, tcw), the points X, the kept
    observations (obs_k, obs_p, uv, w) and whether each lies in front of
    its camera. The window is the map's last `W_KF_BA` keyframe slots."""
    end = rec["end"]
    valid_all = end["map.kf_valid"].astype(bool)
    kf_cap, n_kf = len(valid_all), int(end["map.n_kf"])
    W = min(W_KF_BA, kf_cap)
    lo = int(np.clip(n_kf - W, 0, kf_cap - W))
    win = lo + np.arange(W)
    valid = valid_all[win]
    Rwc = end["map.kf_ns.R"][win].astype(np.float64)
    Rcw = np.swapaxes(Rwc, -1, -2)
    tcw = -np.einsum("kij,kj->ki", Rcw, end["map.kf_ns.p"][win].astype(np.float64))
    fpt = end["map.kf_feat_pt"][win]
    pt_valid = end["map.pt_valid"].astype(bool)
    ok = ((fpt >= 0) & end["map.kf_feat_valid"][win].astype(bool) & valid[:, None]
          & pt_valid[np.clip(fpt, 0, len(pt_valid) - 1)])
    obs_k, f = np.nonzero(ok)
    ids, obs_p = np.unique(fpt[obs_k, f], return_inverse=True)
    uv = end["map.kf_feat_xy"][win][obs_k, f].astype(np.float64)
    lvl = np.clip(end["map.kf_feat_level"][win][obs_k, f], 0, len(SCALE_SIGMAS) - 1)
    X = end["map.pt_xyz"][ids].astype(np.float64)
    front = np.einsum("oij,oj->oi", Rcw[obs_k], X[obs_p])[:, 2] + tcw[obs_k, 2] > 0
    K = rec["dive"].K
    return dict(Rcw=Rcw, tcw=tcw, X=X, obs_k=obs_k, obs_p=obs_p, uv=uv, w=1.0 / SCALE_SIGMAS[lvl],
                cam=(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), front=front)


def kept_chi2(rec, vio: bool) -> float:
    """The largest weighted squared reprojection error (float64) of an
    observation that the last window BA kept, at the map it left; inf for
    one behind its camera."""
    b = ba_window(rec, vio)
    if not b["front"].all():
        return INF
    chi2 = ref.obs_chi2(b["Rcw"], b["tcw"], b["X"], b["obs_k"], b["obs_p"], b["uv"], b["w"],
                        b["cam"])
    return float(np.max(chi2, initial=0.0))


def refine_gaps(rec, vio: bool, tf32: bool) -> np.ndarray:
    """Per track carried through a judged frame (alive before and after
    it; VIP: with no landmark): the distance (px) from the program's
    position after the frame to the plain propagation's (`reference.
    propagate`) from the state before it, or with `tf32` from the TF32
    propagation's; inf where the plain propagation drops the track."""
    out = []
    for s, pre in zip(rec["snaps"], rec["pres"]):
        f = int(s["frame_id"])
        carried = (pre["tracks.valid"].astype(bool) & s["tracks.valid"].astype(bool)
                   & (s["tracks.birth_frame"] < f))
        guess = guess_ok = None
        if vio:
            carried &= pre["tracks.pt_id"] < 0
        else:
            guess, guess_ok = motion_guess(pre, rec["dive"].K)
        if f < 1 or not carried.any():
            continue
        tpl = tuple(pre[k] for k in ("tracks.tpl", "tracks.tpl_gx", "tracks.tpl_gy"))
        tpl2 = tuple(pre[k] for k in ("tracks.tpl2", "tracks.tpl2_gx", "tracks.tpl2_gy"))
        args = (rec["image"](f - 1), rec["image"](f), pre["tracks.xy"], pre["tracks.valid"],
                tpl, tpl2, guess, guess_ok)
        want, ok = ref.propagate(*args)
        got = ref.propagate(*args, tf32=True)[0] if tf32 else s["tracks.xy"]
        gap = np.linalg.norm(got.astype(np.float64) - want, axis=-1)
        out.append(np.where(ok, gap, INF)[carried])
    return np.concatenate(out) if out else np.zeros(0)


def motion_guess(pre, K):
    """Mono: the tracks' guesses, their landmarks projected by the velocity
    model's pose (R_vel Rcw, R_vel tcw + t_vel), and where they hold (a
    landmark over 0.1 in front)."""
    Rp = pre["R_vel"].astype(np.float64) @ pre["Rcw"].astype(np.float64)
    tp = pre["R_vel"].astype(np.float64) @ pre["tcw"].astype(np.float64) + pre["t_vel"]
    pid = pre["tracks.pt_id"]
    X = pre["map.pt_xyz"][np.clip(pid, 0, len(pre["map.pt_xyz"]) - 1)].astype(np.float64)
    pc = X @ Rp.T + tp
    z = np.where(np.abs(pc[:, 2]) < 1e-6, 1e-6, pc[:, 2])
    uv = np.stack([K[0, 0] * pc[:, 0] / z + K[0, 2], K[1, 1] * pc[:, 1] / z + K[1, 2]], -1)
    return uv, pre["tracks.valid"].astype(bool) & (pid >= 0) & (pc[:, 2] > 0.1)


def q90(a) -> float:
    """The 90th percentile (nearest rank) of a, 0 when empty."""
    a = np.sort(np.asarray(a, np.float64))
    return float(a[int(np.ceil(0.9 * len(a))) - 1]) if len(a) else 0.0


def template_gap(rec, tf32: bool) -> float:
    gap = 0.0
    for s in rec["snaps"]:
        born = s["tracks.valid"] & (s["tracks.birth_frame"] == s["frame_id"])
        if not born.any():
            continue
        img = rec["image"](int(s["frame_id"]))
        xy = s["tracks.xy"][born]
        want = ref.templates(img, xy)
        got = ref.templates(img, xy, tf32=True) if tf32 else \
            (s["tracks.tpl"][born], s["tracks.tpl_gx"][born], s["tracks.tpl_gy"][born])
        gap = max(gap, max(float(np.max(np.abs(g - w))) for g, w in zip(got, want)))
    return gap


def preint_gaps(rec, tf32: bool):
    d = rec["dive"]
    gR = gV = gP = 0.0
    for s in rec["snaps"]:
        f, lk = int(s["frame_id"]), int(s["last_kf_frame"])
        if int(s["state"]) != WORKING or lk < 0 or lk >= f:
            continue
        m = d.imu_mask[lk + 1:f + 1] > 0
        omg, acc, dt = d.imu_omg[lk + 1:f + 1][m], d.imu_acc[lk + 1:f + 1][m], \
            d.imu_dt[lk + 1:f + 1][m]
        R0, V0, P0, t0 = ref.preintegrate(omg, acc, dt)
        if not tf32 and abs(float(s["preint_kf.dt"]) - t0) > 1e-4:
            return INF, INF, INF          # integrated over other samples than the window's
        if tf32:
            R1, V1, P1, _ = ref.preintegrate(omg, acc, dt, tf32=True)
        else:
            R1, V1, P1 = s["preint_kf.dR"], s["preint_kf.dV"], s["preint_kf.dP"]
        gR = max(gR, ref.so3_angle(R0.T @ R1))
        gV = max(gV, float(np.linalg.norm(V1 - V0)))
        gP = max(gP, float(np.linalg.norm(P1 - P0)))
    return gR, gV, gP


def depth_gap(rec, tf32: bool) -> float:
    end = rec["end"]
    ok = end["map.kf_valid"] & end["map.kf_depth_valid"]
    want = rec["dive"].depth[end["map.kf_frame_id"][ok]]
    got = ref.to_tf32(want) if tf32 else end["map.kf_depth"][ok]
    return float(np.max(np.abs(got.astype(np.float64) - want), initial=0.0))


def judge(recs, limits: dict, tf32: bool = False) -> dict:
    """{name: (value, limit)} over the records of every stream's dives."""
    out = {}

    def worst(name, values):
        out[name] = (max(values, default=0.0), float(limits[name]))

    worst("not_working_share", [0.0 if tf32 else float(np.mean(r["state"] != WORKING))
                                for r in recs])
    worst("dives_without_vio", [0.0 if tf32 else float(not r["vio"].any()) for r in recs])
    worst("ate_span_share", [0.0 if tf32 else frame_ate(r, True) for r in recs])
    worst("kf_ate_span_share", [0.0 if tf32 else kf_ate(r, True) for r in recs])
    worst("ba_kept_chi2", [0.0 if tf32 else kept_chi2(r, True) for r in recs])
    worst("refine_gap", [q90(refine_gaps(r, True, tf32)) for r in recs])
    gaps = [preint_gaps(r, tf32) for r in recs]
    worst("preint_dR_rad", [g[0] for g in gaps])
    worst("preint_dV_mps", [g[1] for g in gaps])
    worst("preint_dP_m", [g[2] for g in gaps])
    worst("template_gap", [template_gap(r, tf32) for r in recs])
    worst("kf_depth_gap", [depth_gap(r, tf32) for r in recs])
    return out


def spread(a) -> list:
    """[median, 90th percentile, largest, count] of a, for the record."""
    a = np.asarray(a, np.float64)
    return [float(np.median(a)), q90(a), float(a.max()), len(a)] if len(a) else [0, 0, 0, 0]


def per_dive(rec) -> dict:
    """One stream-dive's figures, for the record: its scene, the frames in
    each tracking state, the first WORKING frame and VIO frame, ATE over
    the span of the frames and of the keyframe poses, the BA's largest
    kept error and the spread of the refinement's gaps (`spread`)."""
    st = rec["state"]
    working = np.flatnonzero(st == WORKING)
    return dict(k=rec["k"], stream=rec["stream"], scene=rec["dive"].scene_seed,
                states=[int(np.sum(st == s)) for s in range(5)],
                first_working=int(working[0]) if len(working) else -1,
                vio_frame=int(np.argmax(rec["vio"])) if rec["vio"].any() else -1,
                ate=frame_ate(rec, True), kf_ate=kf_ate(rec, True),
                ba_kept_chi2=kept_chi2(rec, True),
                refine=spread(refine_gaps(rec, True, False)))
