"""Core Gauss-Newton / Levenberg-Marquardt machinery.

Counterpart of `uvipslam_tpu/solver/gn.py`, with the same algorithms so
the port's solves track the reference's: the block-recursive batched SPD
inverse, Jacobi-scaled solves with iterative refinement, the
matmul-only least-squares null vector and a fixed-iteration LM whose
accept/reject is a `torch.where` (no host sync). Replacing them with
`torch.linalg` factorizations is later work.
"""

from __future__ import annotations

import torch

from uvipslam_torch.core.lie import inv3x3
from uvipslam_torch.core.tree import tree_map


def huber_weight(chi2: torch.Tensor, delta2: float) -> torch.Tensor:
    """IRLS weight of the Huber kernel: 1 inside, delta/|r| outside."""
    safe = torch.clamp(chi2, min=1e-12)
    return torch.where(chi2 <= delta2, torch.ones_like(chi2), torch.sqrt(delta2 / safe))


def robust_weight(chi2: torch.Tensor, delta2: float, robust: float) -> torch.Tensor:
    """Huber IRLS weight, identity when `robust` is 0 (a Python number:
    the round schedule is host-side, so this is a plain branch)."""
    return huber_weight(chi2, delta2) if robust > 0 else torch.ones_like(chi2)


def huber_cost(chi2: torch.Tensor, delta2: float) -> torch.Tensor:
    """The Huber objective rho(chi2)."""
    safe = torch.clamp(chi2, min=0.0)
    return torch.where(chi2 <= delta2, safe, 2.0 * torch.sqrt(delta2 * safe) - delta2)


def inv_spd(H: torch.Tensor) -> torch.Tensor:
    """Batched SPD inverse by recursive 2x2 block Schur elimination down
    to closed-form 1/2/3-dim bases."""
    n = H.shape[-1]
    if n == 1:
        return 1.0 / torch.where(torch.abs(H) < 1e-20, torch.full_like(H, 1e-20), H)
    if n == 2:
        a, b = H[..., 0, 0], H[..., 0, 1]
        c, d = H[..., 1, 0], H[..., 1, 1]
        det = a * d - b * c
        det = torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)
        row0 = torch.stack([d, -b], -1)
        row1 = torch.stack([-c, a], -1)
        return torch.stack([row0, row1], -2) / det[..., None, None]
    if n == 3:
        return inv3x3(H)
    m = (n // 2 + 2) // 3 * 3 if n % 3 == 0 else n // 2
    m = min(max(m, 1), n - 1)
    A = H[..., :m, :m]
    B = H[..., :m, m:]
    Cb = H[..., m:, m:]
    Ai = inv_spd(A)
    AiB = Ai @ B
    S = Cb - B.transpose(-1, -2) @ AiB
    Si = inv_spd(S)
    TR = -(AiB @ Si)
    TL = Ai - TR @ AiB.transpose(-1, -2)
    top = torch.cat([TL, TR], dim=-1)
    bot = torch.cat([TR.transpose(-1, -2), Si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def inv_spd_scaled(H: torch.Tensor, refine: int = 2) -> torch.Tensor:
    """Jacobi-scaled `inv_spd` with Newton refinement X <- X (2I - H X)."""
    s = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-12))
    Hs = H * s[..., :, None] * s[..., None, :]
    X = inv_spd(Hs)
    I2 = 2.0 * torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    for _ in range(refine):
        X = X @ (I2 - Hs @ X)
    return X * s[..., :, None] * s[..., None, :]


def nullvec_ls(A: torch.Tensor, eps_rel: float = 3e-6, squarings: int = 3,
               newton: int = 2) -> torch.Tensor:
    """Batched least-squares null vector argmin_{|v|=1} |A v| of
    [.., m, n] systems: inverse power iteration on the regularized Gram
    matrix as the seed, then deflated Newton polish with the residual
    evaluated through A."""
    n = A.shape[-1]
    dtype, dev = A.dtype, A.device
    M = A.transpose(-1, -2) @ A
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
    scale = torch.clamp(tr, min=1e-30)
    Mn = M / scale[..., None, None]
    An = A / torch.sqrt(scale)[..., None, None]
    eye = torch.eye(n, dtype=dtype, device=dev)
    P = inv_spd_scaled(Mn + eps_rel * eye)
    for _ in range(squarings):
        P = P / torch.clamp(torch.amax(torch.abs(P), dim=(-2, -1), keepdim=True), min=1e-30)
        P = P @ P
    cn = torch.sum(P * P, dim=-2)
    j = torch.argmax(cn, dim=-1)
    v = torch.gather(P, -1, j[..., None, None].expand(P.shape[:-2] + (n, 1)))[..., 0]
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-30)
    if newton:
        Mdefl = Mn + v[..., :, None] * v[..., None, :]
        X = inv_spd_scaled(Mdefl)
        for _ in range(newton):
            Av = torch.einsum("...mi,...i->...m", An, v)
            g = torch.einsum("...mi,...m->...i", An, Av)
            d = -torch.einsum("...ij,...j->...i", X, g)
            d = d - v * torch.sum(v * d, dim=-1, keepdim=True)
            v = v + d
            v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-30)
    return v


def solve_spd(H: torch.Tensor, b: torch.Tensor, damping=0.0) -> torch.Tensor:
    """Solve (H + damping*diag(H)) x = b with Jacobi pre-scaling, the
    block-recursive inverse and two refinement steps on the solution."""
    n = H.shape[-1]
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    if isinstance(damping, torch.Tensor):
        damping = damping[..., None, None]
    H = H + damping * eye * torch.clamp(d, min=1e-8)[..., None, :]
    s = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-12))
    Hs = H * s[..., :, None] * s[..., None, :]
    bs = b * s
    X = inv_spd(Hs)
    y = torch.einsum("...ij,...j->...i", X, bs)
    for _ in range(2):
        r = bs - torch.einsum("...ij,...j->...i", Hs, y)
        y = y + torch.einsum("...ij,...j->...i", X, r)
    return y * s


def accumulate_normal_eqs(J: torch.Tensor, r: torch.Tensor, w: torch.Tensor):
    """(Sum_e w_e J_e^T J_e, Sum_e w_e J_e^T r_e) over the edge axis.
    J [E, m, n], r [E, m], w [E]."""
    Jw = J * w[:, None, None]
    H = torch.einsum("emi,emj->ij", Jw, J)
    g = torch.einsum("emi,em->i", Jw, r)
    return H, g


def lm_solve(x0, residual_fn, retract_fn, n_iters: int = 10, lambda0: float = 1e-4):
    """Fixed-iteration dense LM over a tuple of tensors `x0`.
    residual_fn(x) -> (H, g, chi2); retract_fn(x, dx) -> x'. A step is
    kept where chi2 decreases (lambda * 0.5) and discarded otherwise
    (lambda * 4), clamped to [1e-9, 1e6]; one residual build per
    iteration (the accepted equations are carried)."""
    H, g, chi2 = residual_fn(x0)
    lam = torch.full((), lambda0, dtype=chi2.dtype, device=chi2.device)
    x = x0
    for _ in range(n_iters):
        dx = solve_spd(H, -g, damping=lam)
        x_new = retract_fn(x, dx)
        H_new, g_new, chi2_new = residual_fn(x_new)
        accept = chi2_new < chi2
        x = tree_map(lambda a, b: torch.where(accept, b, a), x, x_new)
        H = torch.where(accept, H_new, H)
        g = torch.where(accept, g_new, g)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        chi2 = torch.where(accept, chi2_new, chi2)
    return x, chi2
