"""Per-frame track table: fixed slots with a validity mask.

Counterpart of `uvipslam_tpu/frontend/frame.py`: `Tracks`, track
propagation by two-stage anchor refinement against birth templates plus
an F-RANSAC gate, refill of dead slots with new ORB detections, and the
per-frame unsteered descriptor refresh. On the card, `propagate_tracks`
launches the fused anchor-refinement kernel twice (`ops.klt.anchor_refine_fast`),
and the other two pull patches through `ops.klt.extract_patches_any`:
two templates plus one per ORB level in `refill_tracks`, one in
`refresh_descriptors`.
"""

from __future__ import annotations

import dataclasses

import torch

from uvipslam_torch.ops.image import gaussian_blur, pyr_down
from uvipslam_torch.ops.klt import anchor_refine_fast, extract_templates_fast, global_shift
from uvipslam_torch.ops.orb import extract_orb, orient_and_describe_fast
from uvipslam_torch.ops.twoview import find_fundamental

N_BITS = 256


@dataclasses.dataclass
class Tracks:
    """Fixed-slot track table for the current frame."""

    xy: torch.Tensor         # [N, 2] distorted pixel position (current frame)
    xy_und: torch.Tensor     # [N, 2] undistorted
    desc: torch.Tensor       # [N, 256] i8
    level: torch.Tensor      # [N] i32 pyramid level at detection
    angle: torch.Tensor      # [N] f32
    valid: torch.Tensor      # [N] bool
    pt_id: torch.Tensor      # [N] i32 associated landmark (-1 = none)
    birth_frame: torch.Tensor   # [N] i32
    birth_xy_und: torch.Tensor  # [N, 2]
    age: torch.Tensor        # [N] i32
    tpl: torch.Tensor        # [N, W*W] full-res anchor template
    tpl_gx: torch.Tensor
    tpl_gy: torch.Tensor
    tpl2: torch.Tensor       # [N, W*W] half-res anchor template
    tpl2_gx: torch.Tensor
    tpl2_gy: torch.Tensor

    TPL_WIN = 13

    @staticmethod
    def empty(n: int, dtype=torch.float32, tpl_win: int = 13, device=None) -> "Tracks":
        def z(*s, dt=dtype):
            return torch.zeros(s, dtype=dt, device=device)

        def neg(*s):
            return torch.full(s, -1, dtype=torch.int32, device=device)

        P = tpl_win * tpl_win
        return Tracks(
            xy=z(n, 2), xy_und=z(n, 2), desc=z(n, N_BITS, dt=torch.int8),
            level=z(n, dt=torch.int32), angle=z(n), valid=z(n, dt=torch.bool),
            pt_id=neg(n), birth_frame=neg(n), birth_xy_und=z(n, 2),
            age=z(n, dt=torch.int32),
            tpl=z(n, P), tpl_gx=z(n, P), tpl_gy=z(n, P),
            tpl2=z(n, P), tpl2_gx=z(n, P), tpl2_gy=z(n, P),
        )

    @property
    def n_slots(self) -> int:
        return self.xy.shape[0]


def propagate_tracks(tracks: Tracks, pyr_prev, pyr_cur, guess_xy, guess_ok,
                     gen: torch.Generator, win: int = 21, iters: int = 10,
                     levels: int = 5) -> Tracks:
    """Propagate all tracks prev -> cur: global shift for capture range,
    half-res then full-res anchor refinement, then an F-RANSAC gate
    (draws from `gen`)."""
    lvl = min(3, len(pyr_prev) - 1)
    shift = global_shift(pyr_prev[lvl], pyr_cur[lvl], radius=8) * float(2 ** lvl)
    start = torch.where(guess_ok[:, None], guess_xy, tracks.xy + shift[None, :])

    coarse, ok_c = anchor_refine_fast(
        pyr_cur[1], tracks.tpl2, tracks.tpl2_gx, tracks.tpl2_gy,
        start / 2.0, tracks.valid, win=Tracks.TPL_WIN, iters=10,
        max_correction=5.0, max_residual=45.0)
    mid = torch.where(ok_c[:, None], coarse * 2.0, start)

    nxt, ok_f = anchor_refine_fast(
        pyr_cur[0], tracks.tpl, tracks.tpl_gx, tracks.tpl_gy,
        mid, tracks.valid, win=Tracks.TPL_WIN, max_correction=4.0, max_residual=32.0)
    ok = tracks.valid & ok_f

    _, _, inl = find_fundamental(gen, tracks.xy, nxt, ok, sigma=1.0)
    survived = ok & inl
    return dataclasses.replace(
        tracks,
        xy=torch.where(survived[:, None], nxt, tracks.xy),
        valid=survived,
        age=torch.where(survived, tracks.age + 1, torch.zeros_like(tracks.age)),
    )


def refresh_descriptors(tracks: Tracks, img: torch.Tensor) -> Tracks:
    """Recompute angles and unsteered BRIEF descriptors of live tracks at
    their current positions (the reference's `steer=False`)."""
    blur = gaussian_blur(img, 7, 2.0)
    ang, desc = orient_and_describe_fast(blur, tracks.xy, tracks.valid)
    return dataclasses.replace(
        tracks,
        angle=torch.where(tracks.valid, ang, tracks.angle),
        desc=torch.where(tracks.valid[:, None], desc, tracks.desc),
    )


def refill_tracks(tracks: Tracks, img: torch.Tensor, frame_id, n_features: int = 400,
                  px_distance: int = 20) -> Tracks:
    """Detect new ORB features away from live tracks and place the k-th
    best detection into the k-th dead slot (slot order)."""
    feats = extract_orb(img, tracks.xy, tracks.valid, n_features=n_features,
                        px_distance=px_distance)
    neg_inf = torch.full_like(feats.score, -float("inf"))
    det_order = torch.sort(-torch.where(feats.valid, feats.score, neg_inf),
                           stable=True).indices
    slot_order = torch.sort(tracks.valid.to(torch.uint8), stable=True).indices

    n_dead = torch.sum(~tracks.valid)
    N = tracks.n_slots
    dev = img.device
    k = torch.arange(N, device=dev)
    det_idx = det_order[torch.clamp(k, max=feats.xy.shape[0] - 1)]
    take = (k < n_dead) & feats.valid[det_idx]
    dst = slot_order[k]

    def fill(table, newvals):
        upd = newvals[det_idx]
        sel = take.reshape((N,) + (1,) * (upd.dim() - 1))
        out = table.clone()
        out[dst] = torch.where(sel, upd.to(table.dtype), table[dst])
        return out

    tplT, tplX, tplY = extract_templates_fast(img, feats.xy, win=Tracks.TPL_WIN)
    img2 = pyr_down(img)
    tpl2T, tpl2X, tpl2Y = extract_templates_fast(img2, feats.xy / 2.0, win=Tracks.TPL_WIN)
    n_det = feats.xy.shape[0]
    fid = frame_id.to(torch.int32).reshape(()).expand(n_det) if isinstance(
        frame_id, torch.Tensor) else torch.full((n_det,), frame_id, dtype=torch.int32,
                                                device=dev)
    return dataclasses.replace(
        tracks,
        xy=fill(tracks.xy, feats.xy),
        desc=fill(tracks.desc, feats.desc),
        level=fill(tracks.level, feats.level),
        angle=fill(tracks.angle, feats.angle),
        valid=fill(tracks.valid, torch.ones(n_det, dtype=torch.bool, device=dev)),
        pt_id=fill(tracks.pt_id, torch.full((n_det,), -1, dtype=torch.int32, device=dev)),
        birth_frame=fill(tracks.birth_frame, fid),
        age=fill(tracks.age, torch.zeros(n_det, dtype=torch.int32, device=dev)),
        tpl=fill(tracks.tpl, tplT), tpl_gx=fill(tracks.tpl_gx, tplX),
        tpl_gy=fill(tracks.tpl_gy, tplY),
        tpl2=fill(tracks.tpl2, tpl2T), tpl2_gx=fill(tracks.tpl2_gx, tpl2X),
        tpl2_gy=fill(tracks.tpl2_gy, tpl2Y),
    )
