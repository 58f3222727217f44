"""Hopper kernels for the DLRM dot interaction and its backward, beside
their plain versions.

``dot_interaction_cuda`` launches ``csrc/dot_interaction.cu`` (the port of
``dot_interaction_pallas``): [B, F, D] -> [B, F(F∓1)/2], the lower gram
triangle per sample in ``np.tril_indices`` order, f32-accumulated and
stored in the input dtype.  ``dot_interaction_bwd_cuda`` launches
``csrc/dot_interaction_bwd.cu`` (the port of the JAX package's ``_dot_bwd``):
the triangle's cotangent and the forward's input -> dfeats = sym(g) ·
feats.  ``dot_interaction_ref`` and ``dot_interaction_bwd_ref`` are the
plain versions.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (dot_interaction_bwd_ref,
                                     dot_interaction_ref)

__all__ = ["dot_interaction_cuda", "dot_interaction_ref",
           "dot_interaction_bwd_cuda", "dot_interaction_bwd_ref",
           "bwd_smem_bytes"]

#: columns of feats a block of the backward stages at once (kChunk in
#: csrc/dot_interaction_bwd.cu)
BWD_CHUNK = 128


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


def bwd_smem_bytes(f: int, d: int) -> int:
    """Shared memory of a block of the backward at F rows of width D: sym
    [F, F rounded up to 4] and a chunk of feats [F, min(D, 128)], f32."""
    return 4 * f * (-(-f // 4) * 4 + min(d, BWD_CHUNK))


def dot_interaction_bwd_cuda(g: torch.Tensor, feats: torch.Tensor,
                             self_interaction: bool = False) -> torch.Tensor:
    """The triangle's cotangent g [B, n_pairs] (any row stride, elements
    contiguous) and feats [B, F, D] on the card -> dfeats [B, F, D] in
    ``feats``' dtype."""
    if not (feats.is_cuda and g.device == feats.device):
        raise ValueError("dot_interaction_bwd_cuda needs g and feats on one "
                         "CUDA device")
    if feats.dim() != 3 or not feats.is_contiguous():
        raise ValueError(f"feats must be a contiguous [B, F, D] tensor, got "
                         f"{tuple(feats.shape)}")
    b, f, d = feats.shape
    n_pairs = f * (f + 1) // 2 if self_interaction else f * (f - 1) // 2
    if g.shape != (b, n_pairs) or g.dtype != feats.dtype or \
            (n_pairs > 1 and g.stride(1) != 1):
        raise ValueError(f"g must be [{b}, {n_pairs}] {feats.dtype} with "
                         f"contiguous elements, got {g.dtype} "
                         f"{tuple(g.shape)} strides {g.stride()}")
    if f < 1 or d < 1 or b >= 2 ** 31 or f * d >= 2 ** 31 or \
            bwd_smem_bytes(f, d) > _build.MAX_SMEM:
        raise ValueError(f"unsupported shape {tuple(feats.shape)}")
    code = _build.dtype_code(feats)
    if b == 0 or n_pairs == 0:
        return torch.zeros_like(feats)
    out = torch.empty_like(feats)
    err = _build.library().dot_interaction_bwd_launch(
        g.data_ptr(), g.stride(0), feats.data_ptr(), out.data_ptr(), b, f, d,
        code, int(self_interaction), _build.stream_ptr(feats))
    _build.check("dot_interaction_bwd", err)
    dot_interaction_bwd_cuda.launches += 1
    return out


dot_interaction_bwd_cuda.launches = 0
