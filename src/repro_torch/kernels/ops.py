"""Public serve-path ops, dispatched by device.

A CUDA tensor goes to the Hopper kernel, a CPU tensor to the plain
version, and any other device raises: nothing falls back.  (The JAX
package chose by ``jax.default_backend()`` and a ``use_kernel`` flag; here
``use_kernel`` only chooses the fused serve path or the unfused one, in
``models/recsys.py``.)

The ops are forward only for now: each is a ``torch.autograd.Function``
whose backward raises ``NotImplementedError`` until the training slice
ports the JAX package's custom VJPs.  The serve path runs under
``torch.inference_mode()``.
"""

from __future__ import annotations

import torch

from repro_torch.core.robe import RobeSpec
from repro_torch.kernels.dot_interaction import (dot_interaction_cuda,
                                                 dot_interaction_ref)
from repro_torch.kernels.robe_lookup import robe_lookup_cuda, robe_lookup_ref
from repro_torch.kernels.serve_fused import serve_fused_cuda, serve_fused_ref

__all__ = ["robe_lookup", "dot_interaction", "serve_fused"]


def _on_cuda(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


class _ForwardOnly(torch.autograd.Function):
    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the repro_torch serve ops are forward only; their backward "
            "comes with the training slice of the port")


class _RobeLookup(_ForwardOnly):
    @staticmethod
    def forward(ctx, memory, rows, table_ids, dim, spec):
        fn = robe_lookup_cuda if _on_cuda(memory) else robe_lookup_ref
        return fn(memory, rows, table_ids, dim, spec)


class _DotInteraction(_ForwardOnly):
    @staticmethod
    def forward(ctx, feats, self_interaction):
        fn = dot_interaction_cuda if _on_cuda(feats) else dot_interaction_ref
        return fn(feats, self_interaction)


class _ServeFused(_ForwardOnly):
    @staticmethod
    def forward(ctx, memory, idx, bot, table_ids, dim, spec):
        fn = serve_fused_cuda if _on_cuda(memory) else serve_fused_ref
        return fn(memory, idx, bot, table_ids, dim, spec)


def robe_lookup(memory: torch.Tensor, rows: torch.Tensor, table_ids,
                dim: int, spec: RobeSpec) -> torch.Tensor:
    """[B, F] int32 rows -> [B, F, dim] embeddings through the ROBE array."""
    return _RobeLookup.apply(memory, rows, tuple(table_ids), dim, spec)


def dot_interaction(feats: torch.Tensor, self_interaction: bool = False
                    ) -> torch.Tensor:
    """[B, F, D] -> [B, F*(F±1)/2] pairwise dots (DLRM interaction)."""
    return _DotInteraction.apply(feats, self_interaction)


def serve_fused(memory: torch.Tensor, idx: torch.Tensor, bot: torch.Tensor,
                table_ids, dim: int, spec: RobeSpec) -> torch.Tensor:
    """Fused multi-field ROBE lookup -> bag pooling -> dot interaction.

    idx [B, F] or [B, F, bag] (-1-padded bags), bot [B, dim] ->
    [B, (F+1)·F/2] strictly-lower gram triangle of [bot; pooled emb], in
    ``bot``'s dtype.
    """
    return _ServeFused.apply(memory, idx, bot, tuple(table_ids), dim, spec)
