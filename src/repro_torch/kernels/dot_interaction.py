"""Hopper kernel for the DLRM dot interaction, beside its plain version.

``dot_interaction_cuda`` launches ``csrc/dot_interaction.cu`` (the port of
``dot_interaction_pallas``): [B, F, D] -> [B, F(F∓1)/2], the lower gram
triangle per sample in ``np.tril_indices`` order, f32-accumulated and
stored in the input dtype.  ``dot_interaction_ref`` is the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import dot_interaction_ref

__all__ = ["dot_interaction_cuda", "dot_interaction_ref"]


def dot_interaction_cuda(feats: torch.Tensor,
                         self_interaction: bool = False) -> torch.Tensor:
    """[B, F, D] on the card -> [B, n_pairs] in ``feats``' dtype."""
    if not feats.is_cuda:
        raise ValueError("dot_interaction_cuda needs a CUDA tensor")
    if feats.dim() != 3 or not feats.is_contiguous():
        raise ValueError(f"feats must be a contiguous [B, F, D] tensor, got "
                         f"{tuple(feats.shape)}")
    b, f, d = feats.shape
    if f < 1 or d < 1 or f * (f + 1) // 2 >= 2 ** 31 or b >= 2 ** 31:
        raise ValueError(f"unsupported shape {tuple(feats.shape)}")
    code = _build.dtype_code(feats)
    n_pairs = f * (f + 1) // 2 if self_interaction else f * (f - 1) // 2
    out = torch.empty((b, n_pairs), dtype=feats.dtype, device=feats.device)
    if b == 0 or n_pairs == 0:
        return out
    err = _build.library().dot_interaction_launch(
        feats.data_ptr(), out.data_ptr(), b, f, d, code,
        int(self_interaction), _build.stream_ptr(feats))
    _build.check("dot_interaction", err)
    dot_interaction_cuda.launches += 1
    return out


dot_interaction_cuda.launches = 0
