"""Plain PyTorch versions of the three serve-path kernels.

Each function is the semantics its Hopper kernel is held against: the CPU
path of ``repro_torch.kernels.ops`` runs them, the tests hold them against
the JAX package, and ``chip_smoke.py`` holds each CUDA kernel against them
on the card.  They repeat the kernels' arithmetic (f32 accumulation, one
rounding into the output dtype) and are no yardstick of speed.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.robe import RobeSpec, robe_lookup as _core_lookup


def robe_lookup_ref(memory: torch.Tensor, rows: torch.Tensor,
                    table_ids, dim: int, spec: RobeSpec) -> torch.Tensor:
    """[B, F] rows (+ per-field table ids) -> [B, F, dim] embeddings."""
    tids = torch.as_tensor(table_ids, dtype=torch.int64, device=rows.device)
    return _core_lookup(memory, spec, tids[None, :], rows, dim)


def dot_interaction_ref(feats: torch.Tensor, self_interaction: bool = False
                        ) -> torch.Tensor:
    """DLRM pairwise-dot feature interaction.

    feats: [B, F, D] -> [B, F*(F-1)/2] (strictly-lower triangle of the gram
    matrix, +F diagonal terms if self_interaction) in ``np.tril_indices``
    order -- (1,0), (2,0), (2,1), (3,0), ... -- accumulated in f32 and
    delivered in ``feats``' dtype.
    """
    f32 = feats.to(torch.float32)
    gram = torch.bmm(f32, f32.transpose(1, 2))
    rows, cols = np.tril_indices(feats.shape[1],
                                 k=0 if self_interaction else -1)
    return gram[:, rows, cols].to(feats.dtype)


def serve_fused_ref(memory: torch.Tensor, idx: torch.Tensor,
                    bot: torch.Tensor, table_ids, dim: int,
                    spec: RobeSpec) -> torch.Tensor:
    """ROBE lookup -> masked bag pooling -> DLRM dot interaction against the
    bottom-MLP output, in one function.

    idx: [B, F] or [B, F, bag] int32 row ids (-1 = padded bag slot);
    bot: [B, dim] -> [B, (F+1)·F/2] in ``bot``'s dtype.  Bags are summed in
    f32 and rounded ONCE to ``bot``'s dtype before the f32 gram.
    """
    if idx.dim() == 2:
        idx = idx[..., None]
    mask = idx >= 0
    safe = torch.where(mask, idx, torch.zeros_like(idx))
    tids = torch.as_tensor(table_ids, dtype=torch.int64,
                           device=idx.device)[None, :, None]
    emb = _core_lookup(memory, spec, tids, safe, dim)     # [B, F, bag, dim]
    pooled = (emb.to(torch.float32) * mask[..., None]).sum(dim=2)
    feats = torch.cat([bot[:, None, :], pooled.to(bot.dtype)], dim=1)
    return dot_interaction_ref(feats, False)
