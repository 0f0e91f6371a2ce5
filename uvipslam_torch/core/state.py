"""NavState: the 15-dof inertial navigation state as a tensor dataclass.

Counterpart of `uvipslam_tpu/core/state.py`. A table of N states is a
NavState whose tensors have a leading N dimension.
"""

from __future__ import annotations

import dataclasses

import torch

from uvipslam_torch.core import lie


@dataclasses.dataclass
class NavState:
    p: torch.Tensor    # [..., 3]    position, world
    v: torch.Tensor    # [..., 3]    velocity, world
    R: torch.Tensor    # [..., 3, 3] body->world rotation
    bg: torch.Tensor   # [..., 3]    gyro bias (linearization point)
    ba: torch.Tensor   # [..., 3]    acc bias (linearization point)
    dbg: torch.Tensor  # [..., 3]    delta gyro bias (optimized correction)
    dba: torch.Tensor  # [..., 3]    delta acc bias (optimized correction)

    @staticmethod
    def identity(batch_shape: tuple = (), dtype=torch.float32,
                 device=None) -> "NavState":
        z3 = torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device)
        eye = torch.eye(3, dtype=dtype, device=device).expand(
            tuple(batch_shape) + (3, 3)).clone()
        return NavState(p=z3, v=z3.clone(), R=eye, bg=z3.clone(),
                        ba=z3.clone(), dbg=z3.clone(), dba=z3.clone())

    def inc_small_pvr(self, upd9: torch.Tensor) -> "NavState":
        """P <- P + R*dP ; V <- V + dV ; R <- R*Exp(dPhi)."""
        dp, dv, dphi = upd9[..., 0:3], upd9[..., 3:6], upd9[..., 6:9]
        return dataclasses.replace(
            self,
            p=self.p + lie.mv(self.R, dp),
            v=self.v + dv,
            R=lie.normalize_rotation(lie.mm(self.R, lie.so3_exp(dphi))),
        )

    def inc_small_bias(self, upd6: torch.Tensor) -> "NavState":
        return dataclasses.replace(
            self, dbg=self.dbg + upd6[..., 0:3], dba=self.dba + upd6[..., 3:6])

    @property
    def bg_total(self) -> torch.Tensor:
        return self.bg + self.dbg

    @property
    def ba_total(self) -> torch.Tensor:
        return self.ba + self.dba

    def normalized(self) -> "NavState":
        return dataclasses.replace(self, R=lie.normalize_rotation(self.R))
