"""Tree helpers over the port's tensor dataclasses (the counterpart of
`jax.tree_util.tree_map` for the few places the reference maps over a
state pytree), plus JAX-semantics row reads and writes.

JAX clamps out-of-range gather indices and drops out-of-range scatter
updates; torch raises on both. `row` and `put_row` reproduce JAX's
behavior for a device-scalar index without a host sync.
"""

from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, tree, *rest):
    """Apply `fn` leafwise over dataclasses, tuples and lists of tensors."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *[getattr(r, f.name) for r in rest])
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name),
                          (torch.Tensor, tuple, list)) or
            dataclasses.is_dataclass(getattr(tree, f.name))
        })
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t, *[r[i] for r in rest])
                          for i, t in enumerate(tree))
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    return tree


def row(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """a[k] for a device-scalar index k, clamped like a JAX gather."""
    k = k.reshape(1).long().clamp(0, a.shape[0] - 1)
    return a.index_select(0, k)[0]


def put_row(a: torch.Tensor, k: torch.Tensor, v) -> torch.Tensor:
    """Functional a.at[k].set(v) for a device-scalar index k: a copy with
    row k replaced; an out-of-range k leaves the copy unchanged (JAX
    drops out-of-bounds scatter updates)."""
    n = a.shape[0]
    k = k.reshape(1).long()
    kc = k.clamp(0, n - 1)
    old = a.index_select(0, kc)
    if isinstance(v, torch.Tensor):
        v = v.to(a.dtype).expand_as(old[0]).unsqueeze(0)
    else:  # a Python scalar: filled on the device, no host-to-device copy
        v = torch.full_like(old, v)
    inb = ((k >= 0) & (k < n)).reshape((1,) + (1,) * (a.dim() - 1))
    return a.index_copy(0, kc, torch.where(inb, v, old))


def scatter_rows(table: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Functional table.at[idx].set(vals) for the rows where `mask` holds;
    masked-out rows write nothing. Where several rows target one index the
    last one wins, as in XLA's in-order CPU scatter; the port makes that
    explicit so the result is the same on every device (a plain indexed
    write with duplicate indices is unordered on CUDA)."""
    n, M = table.shape[0], idx.shape[0]
    mask = mask & (idx >= 0) & (idx < n)      # out of range: dropped, as in JAX
    pos = torch.arange(M, device=idx.device)
    key = torch.where(mask, idx.long(), torch.full_like(pos, n))
    winner = torch.full((n + 1,), -1, dtype=torch.long, device=idx.device).scatter_reduce(
        0, key, pos, reduce="amax")
    dst = torch.where(mask & (winner[key] == pos), key, torch.full_like(pos, n))
    out = torch.cat([table, table[:1]], dim=0)   # row n absorbs the losers
    out[dst] = vals.to(table.dtype)
    return out[:n]


def full_like_scalar(v, n: int, dtype, device) -> torch.Tensor:
    """[n] tensor of `v`, a device scalar tensor or a Python number."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype).reshape(()).expand(n)
    return torch.full((n,), v, dtype=dtype, device=device)
