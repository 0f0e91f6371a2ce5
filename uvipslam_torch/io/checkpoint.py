"""Map checkpoints: `save_map` / `load_map` of the port's `MapState`.

Counterpart of `uvipslam_tpu/io/checkpoint.py`, in the same file format:
a `.npz` archive with `n_leaves` and `leaf_0 ... leaf_{n-1}`, the map's
array leaves in the reference's flatten order (the dataclass fields in
declaration order, nested NavState and PreintState tables in theirs;
`core.tree.tree_leaves` walks them the same way). A map saved by either
package loads in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from uvipslam_torch.core.tree import tree_leaves, tree_unflatten
from uvipslam_torch.frontend.tracker import step_device
from uvipslam_torch.mapstate.map import MapState


def save_map(path: str, m: MapState) -> None:
    leaves = tree_leaves(m)
    np.savez_compressed(
        path, n_leaves=len(leaves),
        **{f"leaf_{i}": x.detach().cpu().numpy() for i, x in enumerate(leaves)},
    )


def load_map(path: str, template: MapState | None = None, device="cuda") -> MapState:
    """Restore a MapState onto `device` (the card unless named);
    `template` supplies the structure (a `MapState.empty` of matching
    capacities, on any device: shapes and dtypes are validated)."""
    device = step_device(device)
    if template is None:
        raise ValueError("load_map requires a template MapState for structure")
    data = np.load(path)
    n = int(data["n_leaves"])
    leaves = [data[f"leaf_{i}"] for i in range(n)]
    t_leaves = tree_leaves(template)
    if len(t_leaves) != n:
        raise ValueError(f"leaf count mismatch: {len(t_leaves)} vs {n}")
    out = []
    for a, b in zip(t_leaves, leaves):
        if tuple(a.shape) != tuple(b.shape):
            raise ValueError(f"shape mismatch: {tuple(a.shape)} vs {b.shape}")
        t = torch.from_numpy(np.array(b))   # (ascontiguousarray would make a 0-d leaf 1-d)
        if t.dtype != a.dtype:
            raise ValueError(f"dtype mismatch: {a.dtype} vs {t.dtype}")
        out.append(t.to(device))
    return tree_unflatten(template, out)
