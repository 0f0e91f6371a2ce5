"""Two-view geometry: batched fixed-iteration RANSAC for F and H,
triangulation and motion recovery.

Counterpart of `uvipslam_tpu/ops/twoview.py`. Randomness: minimal
samples are Gumbel-top-k draws from a `torch.Generator`; the stream
differs from `jax.random`, so every RANSAC entry point also takes the
[n_iters, k] sample indices explicitly (`idx=`), which is how the tests
feed both sides the same draws.

`initialize_two_view` evaluates both reconstructions and selects with
`torch.where` (the reference's `lax.cond`), so choosing the model costs
no host sync.
"""

from __future__ import annotations

import torch

from uvipslam_torch.core import lie
from uvipslam_torch.core.lie import mm, mv
from uvipslam_torch.solver.gn import nullvec_ls

TH_F = 3.841
TH_H = 5.991
SCORE_TH = 5.991


def normalize_points(x: torch.Tensor, valid: torch.Tensor):
    """Hartley normalization: zero mean, unit mean abs deviation.
    Returns (xn, T [3, 3])."""
    w = valid.to(x.dtype)
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(x * w[:, None], dim=0) / n
    d = (x - mean) * w[:, None]
    mdev = torch.sum(torch.abs(d), dim=0) / n
    s = 1.0 / torch.clamp(mdev, min=1e-8)
    xn = (x - mean) * s
    z = torch.zeros((), dtype=x.dtype, device=x.device)
    o = torch.ones((), dtype=x.dtype, device=x.device)
    T = torch.stack([
        torch.stack([s[0], z, -mean[0] * s[0]]),
        torch.stack([z, s[1], -mean[1] * s[1]]),
        torch.stack([z, z, o]),
    ])
    return xn, T


def draw_uniform(gen: torch.Generator, n_iters: int, n: int, device) -> torch.Tensor:
    """The [n_iters, n] uniform draws one RANSAC over n slots takes from
    `gen`. A fleet draws them per stream, each from its own generator,
    and hands the stack to the stage it runs over all streams."""
    return torch.rand((n_iters, n), generator=gen, device=device)


def _sample_minimal(gen: torch.Generator, n_iters: int, k: int,
                    valid: torch.Tensor, u: torch.Tensor | None = None) -> torch.Tensor:
    """[n_iters, k] indices of distinct valid correspondences by
    Gumbel-top-k (ties and invalid slots ordered by index), from the
    uniform draws `u` or, without them, from `gen`."""
    n = valid.shape[0]
    if u is None:
        u = draw_uniform(gen, n_iters, n, valid.device)
    u = torch.clamp(u, min=torch.finfo(u.dtype).tiny)
    g = -torch.log(-torch.log(u))
    g = torch.where(valid[None, :], g, torch.full_like(g, -float("inf")))
    return torch.sort(g, dim=1, descending=True, stable=True).indices[:, :k]


def _solve_dlt(A: torch.Tensor) -> torch.Tensor:
    """Unit null vector of each DLT system [..., m, 9]."""
    return nullvec_ls(A)


def _project_rank2(F: torch.Tensor) -> torch.Tensor:
    """F - (F v3) v3^T with v3 = argmin_v |F v|: exactly U diag(s1, s2, 0) V^T."""
    v3 = nullvec_ls(F)
    Fv = torch.einsum("...ij,...j->...i", F, v3)
    return F - Fv[..., :, None] * v3[..., None, :]


def fundamental_from_8pt(xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    x1, y1 = xa[..., 0], xa[..., 1]
    x2, y2 = xb[..., 0], xb[..., 1]
    one = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], dim=-1)
    f = _solve_dlt(A)
    return _project_rank2(f.reshape(f.shape[:-1] + (3, 3)))


def homography_from_4pt(xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    x1, y1 = xa[..., 0], xa[..., 1]
    x2, y2 = xb[..., 0], xb[..., 1]
    z = torch.zeros_like(x1)
    one = torch.ones_like(x1)
    r1 = torch.stack([z, z, z, -x1, -y1, -one, y2 * x1, y2 * y1, y2], dim=-1)
    r2 = torch.stack([x1, y1, one, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    h = _solve_dlt(torch.cat([r1, r2], dim=-2))
    return h.reshape(h.shape[:-1] + (3, 3))


def _homog(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _epipolar_errors(F: torch.Tensor, xa: torch.Tensor, xb: torch.Tensor):
    """Squared point-to-epiline distances both ways; a near-zero F marks
    every point a gross error."""
    ah, bh = _homog(xa), _homog(xb)
    la = torch.einsum("...ij,nj->...ni", F, ah)
    lb = torch.einsum("...ji,nj->...ni", F, bh)
    num_b = torch.einsum("...ni,ni->...n", la, bh) ** 2
    num_a = torch.einsum("...ni,ni->...n", lb, ah) ** 2
    den_b = la[..., 0] ** 2 + la[..., 1] ** 2
    den_a = lb[..., 0] ** 2 + lb[..., 1] ** 2
    bad = torch.full_like(num_b, 1e12)
    d_b = torch.where(den_b > 1e-12, num_b / torch.clamp(den_b, min=1e-12), bad)
    d_a = torch.where(den_a > 1e-12, num_a / torch.clamp(den_a, min=1e-12), bad)
    return d_a, d_b


def _guard(z, eps=1e-12):
    return torch.where(torch.abs(z) < eps, torch.full_like(z, eps), z)


def _homography_errors(H: torch.Tensor, xa: torch.Tensor, xb: torch.Tensor):
    Hinv = lie.inv3x3(H)
    ah, bh = _homog(xa), _homog(xb)
    pb = torch.einsum("...ij,nj->...ni", H, ah)
    pa = torch.einsum("...ij,nj->...ni", Hinv, bh)
    pb = pb[..., :2] / _guard(pb[..., 2:])
    pa = pa[..., :2] / _guard(pa[..., 2:])
    d_b = torch.sum((pb - xb[None]) ** 2, dim=-1)
    d_a = torch.sum((pa - xa[None]) ** 2, dim=-1)
    return d_a, d_b


def _ransac_score(d_a, d_b, valid, th, sigma2):
    big = 1e12
    ca = torch.nan_to_num(d_a / sigma2, nan=big, posinf=big, neginf=big)
    cb = torch.nan_to_num(d_b / sigma2, nan=big, posinf=big, neginf=big)
    in_a = ca < th
    in_b = cb < th
    zero = torch.zeros((), dtype=ca.dtype, device=ca.device)
    sc = (torch.where(in_a & valid[None], SCORE_TH - ca, zero)
          + torch.where(in_b & valid[None], SCORE_TH - cb, zero))
    inlier = in_a & in_b & valid[None]
    return torch.sum(sc, dim=-1), inlier


def _pick(scores, *arrays):
    best = torch.argmax(scores)
    return best, [a.index_select(0, best.reshape(1))[0] for a in arrays]


def find_fundamental(gen, xa, xb, valid, sigma: float = 1.0,
                     n_iters: int = 200, idx: torch.Tensor | None = None,
                     u: torch.Tensor | None = None):
    """RANSAC fundamental matrix with all-inlier refinement; the minimal
    samples are `idx`, or come from the uniform draws `u`
    (`draw_uniform`), or from `gen`.
    Returns (F, score, inliers [N] bool)."""
    xan, Ta = normalize_points(xa, valid)
    xbn, Tb = normalize_points(xb, valid)
    if idx is None:
        idx = _sample_minimal(gen, n_iters, 8, valid, u=u)
    Fs = fundamental_from_8pt(xan[idx], xbn[idx])
    F_full = mm(Tb.T[None], mm(Fs, Ta[None]))
    d_a, d_b = _epipolar_errors(F_full, xa, xb)
    score, inlier = _ransac_score(d_a, d_b, valid, TH_F, sigma * sigma)
    _, (F_b, s_b, inl_b) = _pick(score, F_full, score, inlier)

    w = inl_b.to(xa.dtype)[:, None]
    x1, y1 = xan[:, 0], xan[:, 1]
    x2, y2 = xbn[:, 0], xbn[:, 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1) * w
    f = _solve_dlt(A[None])[0]
    Fr = _project_rank2(f.reshape(3, 3))
    Fr_full = mm(Tb.T, mm(Fr, Ta))
    d_a2, d_b2 = _epipolar_errors(Fr_full[None], xa, xb)
    score2, inlier2 = _ransac_score(d_a2, d_b2, valid, TH_F, sigma * sigma)
    use_ref = score2[0] >= s_b
    return (torch.where(use_ref, Fr_full, F_b),
            torch.where(use_ref, score2[0], s_b),
            torch.where(use_ref, inlier2[0], inl_b))


def find_homography(gen, xa, xb, valid, sigma: float = 1.0,
                    n_iters: int = 200, idx: torch.Tensor | None = None):
    """RANSAC homography with all-inlier DLT refinement.
    Returns (H, score, inliers [N] bool)."""
    xan, Ta = normalize_points(xa, valid)
    xbn, Tb = normalize_points(xb, valid)
    if idx is None:
        idx = _sample_minimal(gen, n_iters, 4, valid)
    Hs = homography_from_4pt(xan[idx], xbn[idx])
    H_full = mm(lie.inv3x3(Tb)[None], mm(Hs, Ta[None]))
    d_a, d_b = _homography_errors(H_full, xa, xb)
    score, inlier = _ransac_score(d_a, d_b, valid, TH_H, sigma * sigma)
    _, (H_b, s_b, inl_b) = _pick(score, H_full, score, inlier)

    w = inl_b.to(xa.dtype)[:, None]
    x1, y1 = xan[:, 0], xan[:, 1]
    x2, y2 = xbn[:, 0], xbn[:, 1]
    z = torch.zeros_like(x1)
    one = torch.ones_like(x1)
    r1 = torch.stack([z, z, z, -x1, -y1, -one, y2 * x1, y2 * y1, y2], dim=-1) * w
    r2 = torch.stack([x1, y1, one, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1) * w
    h = _solve_dlt(torch.cat([r1, r2], dim=0)[None])[0]
    Hr_full = mm(lie.inv3x3(Tb), mm(h.reshape(3, 3), Ta))
    d_a2, d_b2 = _homography_errors(Hr_full[None], xa, xb)
    score2, inlier2 = _ransac_score(d_a2, d_b2, valid, TH_H, sigma * sigma)
    use_ref = score2[0] >= s_b
    return (torch.where(use_ref, Hr_full, H_b),
            torch.where(use_ref, score2[0], s_b),
            torch.where(use_ref, inlier2[0], inl_b))


# ---------------------------------------------------------------------------
# triangulation + motion recovery
# ---------------------------------------------------------------------------


def triangulate_linear(P1, P2, x1, x2):
    """Linear triangulation by the inhomogeneous 3x3 normal equations.
    P1, P2: [3, 4] or per-point [N, 3, 4]; x1, x2: [N, 2]. Returns [N, 3]."""
    def prows(P, x):
        if P.dim() == 2:
            return (x[..., 0:1] * P[2][None] - P[0][None],
                    x[..., 1:2] * P[2][None] - P[1][None])
        return (x[..., 0:1] * P[..., 2, :] - P[..., 0, :],
                x[..., 1:2] * P[..., 2, :] - P[..., 1, :])

    r1a, r1b = prows(P1, x1)
    r2a, r2b = prows(P2, x2)
    A = torch.stack([r1a, r1b, r2a, r2b], dim=-2)  # [N, 4, 4]
    A = A / torch.clamp(torch.linalg.vector_norm(A, dim=-1, keepdim=True), min=1e-12)
    B = A[..., :3]
    c = A[..., 3]
    H = torch.einsum("...ri,...rj->...ij", B, B)
    g = -torch.einsum("...ri,...r->...i", B, c)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    return mv(lie.inv3x3(H + 1e-10 * eye), g)


def decompose_essential(E: torch.Tensor):
    """E -> (R1, R2, t): candidate motions (R1, +-t), (R2, +-t)."""
    # a non-finite E (degenerate RANSAC) must not raise inside LAPACK; the
    # reference's SVD returns NaNs that fail every acceptance gate
    U, _, Vt = torch.linalg.svd(torch.nan_to_num(E))
    d = torch.linalg.det(mm(U, Vt))
    Vt = Vt * torch.where(d < 0, -1.0, 1.0).to(E.dtype)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = mm(mm(U, W), Vt)
    R2 = mm(mm(U, W.T), Vt)
    t = U[..., :, 2]
    t = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)
    return R1, R2, t


def check_rt(R, t, x1, x2, inlier, K, sigma: float = 1.0):
    """Score motion hypotheses [B] by triangulating all inlier matches
    (cheirality + reprojection + parallax). R [B, 3, 3], t [B, 3].
    Returns (n_good [B], points [B, N, 3], good [B, N], parallax [B])."""
    dtype = x1.dtype
    th2 = 4.0 * sigma * sigma
    B = R.shape[0]
    P1 = torch.cat([K, torch.zeros((3, 1), dtype=dtype, device=K.device)], dim=1)
    P2 = mm(K[None], torch.cat([R, t[:, :, None]], dim=2))          # [B, 3, 4]
    N = x1.shape[0]
    X = triangulate_linear(P1.expand(B, N, 3, 4), P2[:, None].expand(B, N, 3, 4),
                           x1.expand(B, N, 2), x2.expand(B, N, 2))

    finite = torch.all(torch.isfinite(X), dim=-1)
    z1 = X[..., 2]
    Xc2 = mv(R[:, None], X) + t[:, None]
    z2 = Xc2[..., 2]

    C2 = -mv(R.transpose(-1, -2), t)                                 # [B, 3]
    r1 = X
    r2 = X - C2[:, None]
    cosp = torch.sum(r1 * r2, dim=-1) / torch.clamp(
        torch.linalg.vector_norm(r1, dim=-1) * torch.linalg.vector_norm(r2, dim=-1),
        min=1e-12)

    u1 = mv(K, X / _guard(z1[..., None]))[..., :2]
    u2 = mv(K, Xc2 / _guard(z2[..., None]))[..., :2]
    e1 = torch.sum((u1 - x1) ** 2, dim=-1)
    e2 = torch.sum((u2 - x2) ** 2, dim=-1)

    good = (inlier & finite & (z1 > 0) & (z2 > 0)
            & (cosp < 0.99998) & (e1 < th2) & (e2 < th2))
    n_good = torch.sum(good, dim=-1)

    k = min(50, N)
    neg = -torch.where(good, cosp, torch.ones_like(cosp))
    topk_par = torch.sort(neg, dim=-1, descending=True, stable=True).values[..., :k]
    j = torch.clamp(torch.minimum(n_good - 1, torch.full_like(n_good, k - 1)), 0, k - 1)
    cos_sel = -torch.gather(topk_par, -1, j[:, None])[:, 0]
    parallax = torch.rad2deg(torch.arccos(torch.clamp(cos_sel, -1.0, 1.0)))
    parallax = torch.where(n_good > 0, parallax, torch.zeros_like(parallax))
    return n_good, X, good, parallax


def _select_best(n_good, X, good, par, R, t):
    best = torch.argmax(n_good)
    b = best.reshape(1)
    sel = [a.index_select(0, b)[0] for a in (n_good, X, good, par, R, t)]
    n_sorted = torch.sort(n_good).values
    return sel, n_sorted[-2]


def reconstruct_from_fundamental(F, K, x1, x2, inlier, sigma: float = 1.0):
    """Best of the 4 E-decomposition motions by CheckRT, with the
    reference's acceptance tests (clear winner, enough points, parallax)."""
    E = mm(mm(K.T, F), K)
    R1, R2, t = decompose_essential(E)
    cands_R = torch.stack([R1, R1, R2, R2])
    cands_t = torch.stack([t, -t, t, -t])
    n_good, X, good, par = check_rt(cands_R, cands_t, x1, x2, inlier, K, sigma)
    (n_best, X_b, good_b, par_b, R_b, t_b), second = _select_best(
        n_good, X, good, par, cands_R, cands_t)
    n_inliers = torch.sum(inlier)
    min_good = torch.clamp(0.9 * n_inliers, min=50.0)
    ok = ((n_best > second * 1.7) & (n_best.to(x1.dtype) >= min_good)
          & (par_b > 1.0))
    return dict(R=R_b, t=t_b, points=X_b, good=good_b, n_good=n_best,
                parallax=par_b, ok=ok)


def decompose_homography(H: torch.Tensor, K: torch.Tensor):
    """Faugeras-Lustman decomposition into 8 (R, t, n) candidates."""
    dtype, dev = H.dtype, H.device
    A = mm(lie.inv3x3(K), mm(H, K))
    U, d, Vt = torch.linalg.svd(torch.nan_to_num(A))
    V = Vt.transpose(-1, -2)
    s = torch.linalg.det(U) * torch.linalg.det(V)
    d1, d2, d3 = d[0], d[1], d[2]

    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp(d1 * d1 - d2 * d2, min=0.0) / denom)
    aux3 = torch.sqrt(torch.clamp(d2 * d2 - d3 * d3, min=0.0) / denom)
    x1s = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=dtype, device=dev) * aux1
    x3s = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=dtype, device=dev) * aux3
    d2s = _guard(d2)
    z4 = torch.zeros(4, dtype=dtype, device=dev)
    o4 = torch.ones(4, dtype=dtype, device=dev)

    sin_t = (d1 - d3) * x1s * x3s / d2s
    cos_t = ((d2 * d2 + d1 * d3) / ((d1 + d3) * d2s)).expand(4)
    Rp_a = torch.stack([torch.stack([cos_t, z4, -sin_t], -1),
                        torch.stack([z4, o4, z4], -1),
                        torch.stack([sin_t, z4, cos_t], -1)], -2)
    tp_a = (d1 - d3) * torch.stack([x1s, z4, -x3s], dim=-1)
    np_a = torch.stack([x1s, z4, x3s], dim=-1)

    sin_p = (d1 + d3) * x1s * x3s / d2s
    cos_p = ((d1 * d3 - d2 * d2) / ((d1 - d3) * d2s)).expand(4)
    Rp_b = torch.stack([torch.stack([cos_p, z4, sin_p], -1),
                        torch.stack([z4, -o4, z4], -1),
                        torch.stack([sin_p, z4, -cos_p], -1)], -2)
    tp_b = (d1 + d3) * torch.stack([x1s, z4, x3s], dim=-1)

    Rp = torch.cat([Rp_a, Rp_b])
    tp = torch.cat([tp_a, tp_b])
    np_ = torch.cat([np_a, np_a])

    Rs = s * torch.einsum("ij,bjk,lk->bil", U, Rp, V)
    ts = torch.einsum("ij,bj->bi", U, tp)
    ts = ts / torch.clamp(torch.linalg.vector_norm(ts, dim=-1, keepdim=True), min=1e-12)
    ns = torch.einsum("ij,bj->bi", V, np_)
    return Rs, ts, ns


def reconstruct_from_homography(H, K, x1, x2, inlier, sigma: float = 1.0):
    """Best of the 8 homography motions by CheckRT (clear winner at
    ratio 0.75, >= 90% of inliers triangulated, parallax gate)."""
    Rs, ts, _ = decompose_homography(H, K)
    n_good, X, good, par = check_rt(Rs, ts, x1, x2, inlier, K, sigma)
    (n_best, X_b, good_b, par_b, R_b, t_b), second = _select_best(
        n_good, X, good, par, Rs, ts)
    n_inliers = torch.sum(inlier)
    min_good = torch.clamp(0.9 * n_inliers, min=50.0)
    ok = ((second.to(x1.dtype) < 0.75 * n_best.to(x1.dtype))
          & (n_best.to(x1.dtype) >= min_good) & (par_b > 1.0))
    return dict(R=R_b, t=t_b, points=X_b, good=good_b, n_good=n_best,
                parallax=par_b, ok=ok)


def initialize_two_view(gen, xa, xb, valid, K, sigma: float = 1.0,
                        n_iters: int = 200, idx_f: torch.Tensor | None = None,
                        idx_h: torch.Tensor | None = None):
    """Parallel H/F model selection (RH = SH/(SH+SF) > 0.40) and motion
    recovery. `idx_f`/`idx_h` inject the minimal samples of the two
    RANSACs; otherwise both draw from `gen` (F first)."""
    F, sf, inl_f = find_fundamental(gen, xa, xb, valid, sigma, n_iters, idx=idx_f)
    Hm, sh, inl_h = find_homography(gen, xa, xb, valid, sigma, n_iters, idx=idx_h)
    rh = sh / torch.clamp(sh + sf, min=1e-9)
    use_h = rh > 0.40
    rec_h = reconstruct_from_homography(Hm, K, xa, xb, inl_h, sigma)
    rec_f = reconstruct_from_fundamental(F, K, xa, xb, inl_f, sigma)
    rec = {k: torch.where(use_h, rec_h[k], rec_f[k]) for k in rec_f}
    rec["used_homography"] = use_h
    rec["inliers"] = torch.where(use_h, inl_h, inl_f)
    return rec
