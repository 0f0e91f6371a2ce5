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


# ---------------------------------------------------------------------------
# a stream dimension: stacked trees, stream subsets and vmapped stages
# ---------------------------------------------------------------------------


def tree_leaves(tree) -> list:
    """The tensor leaves of `tree` in `tree_map`'s order."""
    out = []
    tree_map(lambda a: out.append(a) or a, tree)
    return out


def tree_unflatten(template, leaves):
    """`template` with its tensor leaves replaced, in order, by `leaves`."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def stack_streams(trees):
    """A list of per-stream trees -> one tree with a leading [S] on every
    tensor leaf (non-tensor fields are taken from the first)."""
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def unstack_streams(tree) -> list:
    """The inverse of `stack_streams`: a list of S single-stream trees."""
    leaves = tree_leaves(tree)
    n = leaves[0].shape[0]
    return [tree_unflatten(tree, [a[i] for a in leaves]) for i in range(n)]


def take_streams(tree, idx: torch.Tensor):
    """Rows `idx` (a [n] long tensor of distinct streams) of every leaf."""
    return tree_map(lambda a: a.index_select(0, idx), tree)


def put_streams(tree, idx: torch.Tensor, sub):
    """A copy of `tree` whose stream rows `idx` are replaced by the rows
    of `sub` (leaves [n, ...])."""
    return tree_map(lambda a, b: a.index_copy(0, idx, b.to(a.dtype)), tree, sub)


def over_streams(fn, *args, **kwargs):
    """Run the single-stream stage `fn` once over a leading stream
    dimension: every tensor leaf of `args` carries a leading [S]
    (`torch.func.vmap`, so each of fn's operations is issued once for all
    streams); anything else in `args` and all of `kwargs` is shared by the
    streams. fn may return tensors, trees, tuples and dicts of them, and
    values that are no tensors (returned as they are)."""
    flat = [tree_leaves(a) for a in args]
    sizes = [len(f) for f in flat]
    out_template = []

    def inner(*leaves):
        it = iter(leaves)
        rebuilt = [tree_unflatten(a, [next(it) for _ in range(n)])
                   for a, n in zip(args, sizes)]
        out = fn(*rebuilt, **kwargs)
        out_template.append(out)
        return tuple(_out_leaves(out))

    leaves = [x for f in flat for x in f]
    res = torch.func.vmap(inner)(*leaves)
    return _out_rebuild(out_template[0], iter(res))


def _out_leaves(out) -> list:
    if isinstance(out, dict):
        return [x for k in out for x in _out_leaves(out[k])]
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _out_leaves(o)]
    return tree_leaves(out)


def _out_rebuild(out, it):
    if isinstance(out, dict):
        return {k: _out_rebuild(v, it) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_out_rebuild(o, it) for o in out)
    return tree_map(lambda _: next(it), out)
