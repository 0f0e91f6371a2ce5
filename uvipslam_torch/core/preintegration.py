"""IMU preintegration state.

Counterpart of `uvipslam_tpu/core/preintegration.py`. Only the
`PreintState` table is ported so far: the keyframe table of `MapState`
stores one per keyframe. The integration itself (`preintegrate`,
`preintegrate_continue`, `bias_correct`) belongs to the VIP slice.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class PreintState:
    """Accumulated preintegrated measurement between two states."""

    dP: torch.Tensor        # [..., 3]
    dV: torch.Tensor        # [..., 3]
    dR: torch.Tensor        # [..., 3, 3]
    J_P_bg: torch.Tensor    # [..., 3, 3]
    J_P_ba: torch.Tensor    # [..., 3, 3]
    J_V_bg: torch.Tensor    # [..., 3, 3]
    J_V_ba: torch.Tensor    # [..., 3, 3]
    J_R_bg: torch.Tensor    # [..., 3, 3]
    cov: torch.Tensor       # [..., 9, 9]  order: P, V, Phi
    dt: torch.Tensor        # [...]

    @staticmethod
    def zero(batch_shape: tuple = (), dtype=torch.float32,
             device=None) -> "PreintState":
        b = tuple(batch_shape)

        def z(*s):
            return torch.zeros(b + s, dtype=dtype, device=device)

        return PreintState(
            dP=z(3), dV=z(3),
            dR=torch.eye(3, dtype=dtype, device=device).expand(b + (3, 3)).clone(),
            J_P_bg=z(3, 3), J_P_ba=z(3, 3), J_V_bg=z(3, 3), J_V_ba=z(3, 3),
            J_R_bg=z(3, 3), cov=z(9, 9), dt=z(),
        )
