"""The plain reference that decides `correct`: numpy in float64, from the
inputs the benchmark made. It imports nothing of the program (nor jax).

- `preintegrate`: the on-manifold IMU preintegration (Forster et al.,
  RSS 2015) of raw samples, zero bias: dR, dV, dP and the time.
- `templates`: the birth template of a track and its central-difference
  gradients, [13, 13] bilinear samples of the image around the track's
  position (0 outside the image).
- `ate`: the absolute trajectory error after an SE3 or Sim3 (Umeyama)
  alignment;
- `obs_chi2`: each observation's weighted squared reprojection residual
  in the windowed BA's problem (weights 1 / sigma^2 by pyramid level);
- `propagate`: a frame's track propagation, the global shift and the
  anchor refinement at half and full resolution (`anchor_refine`), from
  the tracks the frame starts from.

Each takes `tf32=True` for the control: every product's operands rounded
to TF32 (10 mantissa bits, as the card's tensor cores take float32
operands when TF32 is on), the sums in float32. That is the nearest
precision below the configurations' float32 with TF32 off.
"""

from __future__ import annotations

import numpy as np


def to_tf32(x):
    """float32 values rounded to TF32 (the low 13 mantissa bits rounded
    off, to nearest, ties away from zero), as float32."""
    a = np.ascontiguousarray(np.asarray(x, np.float32))
    b = a.view(np.uint32)
    r = ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).astype(np.uint32)
    return r.view(np.float32).reshape(a.shape)


def _mm(a, b, tf32: bool):
    if tf32:
        return to_tf32(a) @ to_tf32(b)
    return a @ b


def so3_exp(w):
    """Rodrigues' formula, [3] -> [3, 3], in w's precision."""
    th = np.sqrt(np.sum(w * w))
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]], dtype=w.dtype)
    if th < 1e-12:
        return np.eye(3, dtype=w.dtype) + K
    return (np.eye(3, dtype=w.dtype) + np.sin(th) / th * K
            + (1 - np.cos(th)) / th ** 2 * (K @ K)).astype(w.dtype)


def so3_angle(R):
    """The rotation angle of R [3, 3] (radians)."""
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    s = 0.5 * np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.arctan2(s, c))


def preintegrate(omg, acc, dt, tf32: bool = False):
    """Zero-bias preintegration of samples omg/acc [N, 3], dt [N] in the
    recurrence's order: dP with the old dV and dR, then dV, then dR.
    float64, or with `tf32` float32 over TF32-rounded products. Returns
    (dR, dV, dP, total time)."""
    ft = np.float32 if tf32 else np.float64
    dR = np.eye(3, dtype=ft)
    dV = np.zeros(3, ft)
    dP = np.zeros(3, ft)
    for w, a, h in zip(np.asarray(omg, ft), np.asarray(acc, ft), np.asarray(dt, ft)):
        Ra = _mm(dR, a, tf32)
        dP = dP + dV * h + ft(0.5) * Ra * h * h
        dV = dV + Ra * h
        dR = _mm(dR, so3_exp(w * h), tf32)
    return dR.astype(np.float64), dV.astype(np.float64), dP.astype(np.float64), \
        float(np.sum(np.asarray(dt, np.float64)))


def _bilinear(img, x, y):
    """Bilinear samples of img [H, W] at (x, y) arrays, 0 outside."""
    H, W = img.shape
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    ax, ay = x - x0, y - y0

    def at(yy, xx):
        ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        return np.where(ok, img[np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)], 0.0)

    return ((1 - ax) * (1 - ay) * at(y0, x0) + ax * (1 - ay) * at(y0, x0 + 1)
            + (1 - ax) * ay * at(y0 + 1, x0) + ax * ay * at(y0 + 1, x0 + 1))


def templates(img, xy, win: int = 13, tf32: bool = False):
    """The birth templates of tracks at xy [N, 2] (pixels) in img [H, W]:
    (T, Tx, Ty), each [N, win * win], the window's samples at offsets
    -win//2..win//2 and their central differences over a (win + 2) window.
    float64, or with `tf32` each sample a float32 sum of TF32-rounded
    products of the image and the interpolation weights."""
    r = win // 2 + 1
    d = np.arange(-r, r + 1, dtype=np.float64)
    xy = np.asarray(xy, np.float64)
    if tf32:
        img = np.asarray(img, np.float32)
        x = xy[:, 0, None] + d[None, :]
        y = xy[:, 1, None] + d[None, :]
        big = np.stack([_bilinear_tf32(img, x[i], y[i]) for i in range(len(xy))]) \
            if len(xy) else np.zeros((0, 2 * r + 1, 2 * r + 1))
    else:
        img = np.asarray(img, np.float64)
        X = xy[:, 0, None, None] + d[None, None, :]
        Y = xy[:, 1, None, None] + d[None, :, None]
        big = _bilinear(img, X, Y)
    T = big[:, 1:-1, 1:-1]
    Tx = 0.5 * (big[:, 1:-1, 2:] - big[:, 1:-1, :-2])
    Ty = 0.5 * (big[:, 2:, 1:-1] - big[:, :-2, 1:-1])
    n = len(xy)
    return T.reshape(n, -1), Tx.reshape(n, -1), Ty.reshape(n, -1)


def _hat(off, size_out, size_in):
    """[size_out, size_in] bilinear weights of the samples off + j."""
    j = np.arange(size_out)[:, None]
    k = np.arange(size_in)[None, :]
    return np.clip(1.0 - np.abs(off + j - k), 0.0, 1.0)


def _bilinear_tf32(img, xs, ys):
    """The [n, n] window of samples at columns xs and rows ys as two
    products of interpolation weights and image rows and columns, each
    with TF32-rounded operands and float32 sums."""
    H, W = img.shape
    x0 = int(np.floor(xs[0])) - 1
    y0 = int(np.floor(ys[0])) - 1
    n = len(xs)
    cols = np.arange(x0, x0 + n + 3)
    rows = np.arange(y0, y0 + n + 3)
    ok = (rows[:, None] >= 0) & (rows[:, None] < H) & (cols[None, :] >= 0) & (cols[None, :] < W)
    patch = np.where(ok, img[np.clip(rows, 0, H - 1)[:, None], np.clip(cols, 0, W - 1)[None, :]],
                     0.0).astype(np.float32)
    Wy = _hat(ys[0] - y0, n, len(rows)).astype(np.float32)
    Wx = _hat(xs[0] - x0, n, len(cols)).astype(np.float32)
    return _mm(_mm(Wy, patch, True), Wx.T, True).astype(np.float64)


def _windows_tf32(img, x_first, y_first, n: int):
    """`_bilinear_tf32` for many windows at once: [N, n, n] samples at
    columns x_first[i] + 0..n-1 and rows y_first[i] + 0..n-1."""
    H, W = img.shape
    x0 = np.floor(x_first).astype(np.int64) - 1
    y0 = np.floor(y_first).astype(np.int64) - 1
    k = np.arange(n + 3)
    cols, rows = x0[:, None] + k, y0[:, None] + k                        # [N, n + 3]
    ok = ((rows[:, :, None] >= 0) & (rows[:, :, None] < H)
          & (cols[:, None, :] >= 0) & (cols[:, None, :] < W))
    patch = np.where(ok, img[np.clip(rows, 0, H - 1)[:, :, None],
                             np.clip(cols, 0, W - 1)[:, None, :]], 0.0).astype(np.float32)
    j = np.arange(n)[None, :, None]
    Wy = np.clip(1.0 - np.abs((y_first - y0)[:, None, None] + j - k[None, None, :]), 0.0,
                 1.0).astype(np.float32)
    Wx = np.clip(1.0 - np.abs((x_first - x0)[:, None, None] + j - k[None, None, :]), 0.0,
                 1.0).astype(np.float32)
    tmp = to_tf32(Wy) @ to_tf32(patch)
    return (to_tf32(tmp) @ to_tf32(np.swapaxes(Wx, 1, 2))).astype(np.float64)


def ate(est, gt, scale: bool):
    """RMS of the aligned estimate's distances to gt ([N, 3] each) after
    the least-squares rotation and translation, and with `scale` scale,
    that maps est onto gt (Umeyama)."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    U, D, Vt = np.linalg.svd(G.T @ E / len(est))
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / max((E * E).sum() / len(est), 1e-12)) if scale else 1.0
    t = mu_g - s * R @ mu_e
    aligned = (s * (R @ est.T)).T + t
    return float(np.sqrt(((aligned - gt) ** 2).sum(-1).mean()))


def obs_chi2(Rcw, tcw, X, obs_k, obs_p, uv, w, cam):
    """Each observation's weighted squared reprojection residual (float64)
    of points X [P, 3] in cameras (Rcw [K, 3, 3], tcw [K, 3]), observation
    o of point obs_p[o] in camera obs_k[o] at pixel uv[o] with weight
    w[o]; cam is (fx, fy, cx, cy)."""
    fx, fy, cx, cy = cam
    pc = np.einsum("oij,oj->oi", Rcw[obs_k], X[obs_p]) + tcw[obs_k]
    z = np.where(np.abs(pc[:, 2]) < 1e-6, 1e-6, pc[:, 2])
    hat = np.stack([fx * pc[:, 0] / z + cx, fy * pc[:, 1] / z + cy], -1)
    return w * np.sum((hat - uv) ** 2, -1)


# -- the track propagation ----------------------------------------------------
def _q(x, tf32: bool):
    """x as float64, or for the control its TF32 rounding as float32."""
    return to_tf32(x) if tf32 else np.asarray(x, np.float64)


PYR_TAPS = np.float32([1.0, 4.0, 6.0, 4.0, 1.0]) / np.float32(16.0)


def _reflect101(n: int, pad: int):
    i = np.abs(np.arange(-pad, n + pad))
    return np.where(i >= n, 2 * (n - 1) - i, i)


def pyr_down(img):
    """The 5-tap Gaussian (1, 4, 6, 4, 1) / 16 with reflect-101 borders and
    2x decimation, [H, W] -> [(H + 1) // 2, (W + 1) // 2], in img's type."""
    H, W = img.shape
    Ho, Wo = (H + 1) // 2, (W + 1) // 2
    taps = PYR_TAPS.astype(img.dtype)
    p = img[_reflect101(H, 2)]
    v = sum(taps[i] * p[i:i + 2 * Ho - 1:2] for i in range(5))
    q = v[:, _reflect101(W, 2)]
    return sum(taps[j] * q[:, j:j + 2 * Wo - 1:2] for j in range(5))


def global_shift(a, b, radius: int = 8):
    """The integer translation (dx, dy) of image a to b with the least sum
    of squared differences over the (2 r + 1)^2 shifts of a's centre."""
    H, W = a.shape
    r = min(radius, (min(H, W) - 2) // 2)
    n = 2 * r + 1
    Hc, Wc = H - 2 * r, W - 2 * r
    ac = a[r:H - r, r:W - r]
    costs = np.array([[np.sum((b[i:i + Hc, j:j + Wc] - ac) ** 2) for j in range(n)]
                      for i in range(n)])
    k = int(np.argmin(costs.reshape(-1)))
    return np.array([k % n - r, k // n - r], np.float64)


def anchor_refine(img, T, Tx, Ty, pts, valid, win: int, iters: int, max_correction: float,
                  max_residual: float, tf32: bool = False):
    """The anchor refinement of tracks at pts [N, 2] in img [H, W] against
    their templates T, Tx, Ty [N, win * win] (rows of the window about the
    position): in the patch of side win + 2 (int(max_correction) + 2)
    whose corner is clip(floor(pt) - side // 2, 0, dim - side), `iters`
    inverse-compositional steps -G^-1 sum(err * (Tx, Ty)), each clamped to
    3 px and the position to the patch's inner bounds; a track is taken
    where G is regular, the correction at most `max_correction` and the
    mean absolute residual under `max_residual`. Returns (positions,
    taken). float64, or with `tf32` the samples and the step's sums over
    TF32-rounded operands in float32."""
    ft = np.float32 if tf32 else np.float64
    H, W = img.shape
    psize = win + 2 * (int(max_correction) + 2)
    half, r = psize // 2, win // 2
    pts = np.asarray(pts, np.float64)
    fin = np.all(np.isfinite(pts), -1)
    safe = np.where(fin[:, None], pts, 0.0)
    corner = np.stack([np.clip(np.floor(safe[:, 0]) - half, 0, W - psize),
                       np.clip(np.floor(safe[:, 1]) - half, 0, H - psize)], -1)
    local = safe - corner
    T, Tx, Ty = (np.asarray(a, ft) for a in (T, Tx, Ty))
    Gxx, Gxy, Gyy = (np.sum(_q(a, tf32) * _q(b, tf32), 1) for a, b in
                     ((Tx, Tx), (Tx, Ty), (Ty, Ty)))
    det = Gxx * Gyy - Gxy * Gxy
    good = det > 1e-9
    det = np.where(np.abs(det) < 1e-12, 1.0, det)
    d = np.arange(-r, r + 1, dtype=np.float64)

    def sample(p):
        q = corner + p
        if tf32:
            return _windows_tf32(np.asarray(img, np.float32), q[:, 0] - r, q[:, 1] - r,
                                 win).reshape(len(q), -1).astype(np.float32)
        return _bilinear(np.asarray(img, np.float64), q[:, 0, None, None] + d[None, None, :],
                         q[:, 1, None, None] + d[None, :, None]).reshape(len(q), -1)

    lo, hi = float(r), float(psize - r - 2)
    p = local.copy()
    for _ in range(iters):
        err = (sample(p) - T).astype(ft)
        bx = np.sum(_q(err, tf32) * _q(Tx, tf32), 1)
        by = np.sum(_q(err, tf32) * _q(Ty, tf32), 1)
        step = np.clip(np.stack([-(Gyy * bx - Gxy * by) / det,
                                 -(-Gxy * bx + Gxx * by) / det], -1), -3.0, 3.0)
        p = np.clip(p + np.where(good[:, None], step, 0.0), lo, hi)
    resid = np.mean(np.abs(sample(p) - T), 1)
    corr = np.linalg.norm(p - local, axis=-1)
    taken = np.asarray(valid, bool) & fin & good & (corr <= max_correction) & (resid < max_residual)
    return np.where(taken[:, None], pts + (p - local), pts), taken


def propagate(img_prev, img, xy, valid, tpl, tpl2, guess=None, guess_ok=None,
              tf32: bool = False):
    """The tracks' positions in img, from their positions xy [N, 2] in
    img_prev: a start at the guess where `guess_ok`, else at xy plus the
    frame's global shift (found at pyramid level 3, times 8); the anchor
    refinement at half resolution (10 steps, correction 5 px, residual 45)
    from start / 2 against the half-resolution templates `tpl2`, then at
    full resolution (8 steps, 4 px, 32) from twice its result, or the
    start where it failed, against `tpl`. Returns (positions, taken)."""
    ft = np.float32 if tf32 else np.float64
    pp, pc = [np.asarray(img_prev, ft)], [np.asarray(img, ft)]
    for _ in range(3):
        pp.append(pyr_down(pp[-1]))
        pc.append(pyr_down(pc[-1]))
    shift = global_shift(pp[3], pc[3]) * 8.0
    xy = np.asarray(xy, np.float64)
    start = xy + shift if guess is None else np.where(guess_ok[:, None], guess, xy + shift)
    coarse, ok_c = anchor_refine(pc[1], *tpl2, start / 2.0, valid, 13, 10, 5.0, 45.0, tf32)
    mid = np.where(ok_c[:, None], coarse * 2.0, start)
    return anchor_refine(pc[0], *tpl, mid, valid, 13, 8, 4.0, 32.0, tf32)
