"""The mono configuration's judge: the plain reference (`reference.py`)
against what the timed path produced, stream by stream and dive by dive.

Numbers compared, each at most its limit (the configuration's `limits`):

- `not_working_share`: the largest share of a dive's frames not tracked
  WORKING (the configuration's gate: at least 80% WORKING);
- `ate_span_share`: the largest Sim3-aligned ATE of a dive's WORKING
  frames over the ground truth's span (the gate: below 2%);
- `kf_ate_span_share`: the same of the keyframe poses that the windowed
  BA leaves in the map at the dive's end (the same gate);
- `ba_kept_chi2`: the map that the last windowed BA of the dive left,
  against the BA's bound of 5.991 on the observations it keeps, the
  configuration's limit (`references/vip.py`);
- `refine_gap`: the anchor refinement kernel's output against the plain
  propagation from the state each judged frame started from, every
  carried track (`references/vip.py`);
- `template_gap`: the largest gap (gray levels) of a track's birth
  template and gradients, made by the patch-pull kernel and the
  interpolation products, to the reference's samples of the dive's image
  at the track's position, over the tracks born in the judged frames.

With `tf32` the reference in TF32 stands in the program's place (the
control): its templates and propagated positions against the float64
reference; the numbers whose limit the configuration states (the
tracking gates and the BA's bound) read 0.
"""

from __future__ import annotations

import numpy as np

from references.vip import (PRE as VIP_PRE, WORKING, frame_ate, kept_chi2, kf_ate, q90,
                            refine_gaps, spread, template_gap)

SNAP = ("frame_id", "state", "tracks.xy", "tracks.valid", "tracks.birth_frame", "tracks.tpl",
        "tracks.tpl_gx", "tracks.tpl_gy")
# ... and before them: the tracks and the velocity model's pose the frame starts from
PRE = VIP_PRE + ("Rcw", "tcw", "R_vel", "t_vel", "map.pt_xyz")
END = ("map.kf_valid", "map.kf_frame_id", "map.kf_ns.p", "map.kf_ns.R", "map.kf_feat_xy",
       "map.kf_feat_pt", "map.kf_feat_valid", "map.kf_feat_level", "map.pt_xyz",
       "map.pt_valid", "map.n_kf")


def judge(recs, limits: dict, tf32: bool = False) -> dict:
    """{name: (value, limit)} over the records of every stream's dives."""
    out = {}

    def worst(name, values):
        out[name] = (max(values, default=0.0), float(limits[name]))

    worst("not_working_share", [0.0 if tf32 else float(np.mean(r["state"] != WORKING))
                                for r in recs])
    worst("ate_span_share", [0.0 if tf32 else frame_ate(r, False) for r in recs])
    worst("kf_ate_span_share", [0.0 if tf32 else kf_ate(r, False) for r in recs])
    worst("ba_kept_chi2", [0.0 if tf32 else kept_chi2(r, False) for r in recs])
    worst("refine_gap", [q90(refine_gaps(r, False, tf32)) for r in recs])
    worst("template_gap", [template_gap(r, tf32) for r in recs])
    return out


def per_dive(rec) -> dict:
    """One stream-dive's figures, for the record: its scene, the frames in
    each tracking state, the first WORKING frame, ATE over the span of the
    frames and of the keyframe poses, the BA's largest kept error and the
    spread of the refinement's gaps (`references.vip.spread`)."""
    st = rec["state"]
    working = np.flatnonzero(st == WORKING)
    return dict(k=rec["k"], stream=rec["stream"], scene=rec["dive"].scene_seed,
                states=[int(np.sum(st == s)) for s in range(5)],
                first_working=int(working[0]) if len(working) else -1,
                ate=frame_ate(rec, False), kf_ate=kf_ate(rec, False),
                ba_kept_chi2=kept_chi2(rec, False),
                refine=spread(refine_gaps(rec, False, False)))
