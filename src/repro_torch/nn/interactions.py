"""Feature interactions (PyTorch port of ``repro.nn.interactions``; the
DLRM dot interaction only, so far)."""

from __future__ import annotations

import torch

from repro_torch.kernels.ops import dot_interaction


def dot_interaction_op(feats: torch.Tensor, self_interaction: bool = False
                       ) -> torch.Tensor:
    return dot_interaction(feats, self_interaction)
