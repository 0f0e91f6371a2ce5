"""Rooflines of the program's two hand kernels on the timed path, from the
profiler's records of their launches.

The peaks are one NVIDIA H100 SXM's published rates at 700 W: 3.35 TB/s
of HBM and 67 TFLOP/s in float32 outside the tensor cores. `bound` is a
frozen copy of the program repository's `chip_smoke.py::bound`: the larger
of the bytes over the memory rate and the operations over the float32
rate.

A launch's shape comes from its record in a profile's trace file (the
harness exports the traced dive's last frames: `devtrace.launches`): the
grid is (tracks, streams); the patch pull's block of 64 or 160 threads
gives its patch side, 19 (the birth templates, window 13 + 6) or 35 (the
ORB and descriptor pulls, 31 + 4); the refinement's dynamic shared memory
is its patch (side 27: half resolution, 10 iterations; side 25: full
resolution, 8 iterations) plus 1,024 or 5,120 bytes of the kernel's own
(one warp or two). The counts are `chip_smoke.py::bound`'s:

- patch pull: its patches and positions written once, the positions read
  once; the image under the patches is not counted (the record holds no
  positions: at 400 tracks of side 35 it is a third of what
  `chip_smoke.py` counts), so the share is a lower bound;
- refinement: the positions and flags read and written once, the three
  templates of each live track read once, and the distinct image pixels
  under the patches of the live tracks, at the positions that the frame
  starts from (the harness's record of the state before each exported
  frame; the frame's own starting guess lies a few pixels off, which
  moves the count of distinct pixels little); 6 + 14 x iterations + 12
  flops per template pixel of a live track. The launches pair with the
  exported frames in time order, two to a frame (half, then full
  resolution); where they do not, the image is left out and the live
  share of the traced frames stands for the tracks.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

PULL_PSIZE = {64: 19, 160: 35}           # threads per block -> patch side
REFINE = {27: (10, 2), 25: (8, 1)}       # patch side -> (iterations, image scale divisor)
REFINE_OWN_SMEM = (1024, 5120)           # the refinement kernel's static shared memory
WIN = 13


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the float32 rate."""
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def _dims(m, key):
    v = m.get(key)
    if isinstance(v, list) and len(v) >= 2:
        return int(v[0]), int(v[1])
    return None


def pull_launch(m: dict):
    """(bytes, flops) of one patch-pull launch from its metadata, or None."""
    g, b = _dims(m, "grid"), m.get("block")
    if g is None:
        return None
    n, S = g
    p = PULL_PSIZE.get(int(b[0]) if isinstance(b, list) and b else 0, min(PULL_PSIZE.values()))
    return S * n * (4 * p * p + 8 + 8), 0


def refine_psize(smem) -> int | None:
    """The refinement's patch side from its launch's dynamic shared memory."""
    for own in REFINE_OWN_SMEM:
        q = (int(smem) - own) // 4
        p = int(round(q ** 0.5)) if q > 0 else 0
        if p * p == q and p in REFINE:
            return p
    return None


def window_pixels(xy, valid, H: int, W: int, psize: int) -> int:
    """Distinct pixels of an [H, W] image under the patches at xy [N, 2]
    of the valid rows (`chip_smoke.py::window_pixels`, the program's
    clipped corners)."""
    import numpy as np

    xy = np.asarray(xy, np.float64)
    ok = np.asarray(valid, bool) & np.all(np.isfinite(xy), -1)
    if not ok.any():
        return 0
    half = psize // 2
    x0 = np.clip(np.floor(xy[ok, 0]).astype(np.int64) - half, 0, W - psize)
    y0 = np.clip(np.floor(xy[ok, 1]).astype(np.int64) - half, 0, H - psize)
    d = np.arange(psize)
    idx = (y0[:, None, None] + d[None, :, None]) * W + x0[:, None, None] + d[None, None, :]
    mask = np.zeros(H * W, bool)
    mask[idx.reshape(-1)] = True
    return int(mask.sum())


def refine_launch(m: dict, live_share: float, start=None, hw=None):
    """(bytes, flops) of one refinement launch from its metadata, or None;
    `start` the (positions, flags) [S?, N, ...] its frame starts from and
    `hw` the full-resolution image's size, for the image under the
    patches."""
    import numpy as np

    g = _dims(m, "grid")
    if g is None:
        return None
    n, S = g
    psize = refine_psize(m.get("shared memory", 0))
    iters, div = REFINE.get(psize, (sum(i for i, _ in REFINE.values()) / len(REFINE), None))
    if start is None or div is None:
        live = S * n * live_share
        pixels = 0
    else:
        xy = np.asarray(start[0], np.float64).reshape(S, n, 2) / div
        valid = np.asarray(start[1], bool).reshape(S, n)
        live = int(np.sum(valid & np.all(np.isfinite(xy), -1)))
        H, W = hw[0] // div, hw[1] // div
        pixels = sum(window_pixels(xy[i], valid[i], H, W, psize) for i in range(S))
    nbytes = S * n * 18 + 3 * 4 * WIN * WIN * live + 4 * pixels
    flops = WIN * WIN * (6 + 14 * iters + 12) * live
    return nbytes, flops


def refine_share(hand, starts, hw, live_share):
    """The refinement's share of its roofline over the launches `hand`,
    each paired with the start of its exported frame (two launches to a
    frame, in time order) where the counts agree."""
    own = [h for h in hand if "anchor_refine_kernel" in h[0]]
    paired = len(own) == 2 * len(starts)
    seq = iter(range(len(own)))

    def count(m):
        i = next(seq)
        return refine_launch(m, live_share, starts[i // 2] if paired else None, hw)

    return share(own, "anchor_refine_kernel", count)


def share(hand, kernel: str, count):
    """The kernel's share of its roofline in % over the launches `hand`
    ((name, duration ns, launch arguments)) whose shape is known: the sum
    of their bounds over the sum of their device times; None without such
    a launch."""
    t_bound = t_dev = 0.0
    for name, dur, m in hand:
        if kernel not in name:
            continue
        c = count(m)
        if c is None:
            continue
        t_bound += bound(*c)[0] * 1e-3
        t_dev += dur * 1e-9
    return 100.0 * t_bound / t_dev if t_dev > 0 else None
