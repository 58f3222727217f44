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
from repro_torch.kernels.qr_lookup import qr_lookup_cuda, qr_lookup_ref
from repro_torch.kernels.qrobe_lookup import (qrobe_lookup_cuda,
                                              qrobe_lookup_ref)
from repro_torch.kernels.robe_lookup import robe_lookup_cuda, robe_lookup_ref
from repro_torch.kernels.serve_fused import serve_fused_cuda, serve_fused_ref
from repro_torch.kernels.tt_lookup import tt_lookup_cuda, tt_lookup_ref

__all__ = ["robe_lookup", "dot_interaction", "serve_fused", "qrobe_lookup",
           "qr_lookup", "tt_lookup"]


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


class _QrobeLookup(_ForwardOnly):
    @staticmethod
    def forward(ctx, codes, scale, rows, table_ids, dim, spec, group_log2,
                delta):
        fn = qrobe_lookup_cuda if _on_cuda(codes) else qrobe_lookup_ref
        return fn(codes, scale, rows, table_ids, dim, spec, group_log2,
                  delta)


class _QrLookup(_ForwardOnly):
    @staticmethod
    def forward(ctx, q_table, r_table, idx, q_off, r_off, m):
        fn = qr_lookup_cuda if _on_cuda(q_table) else qr_lookup_ref
        return fn(q_table, r_table, idx, q_off, r_off, m)


class _TtLookup(_ForwardOnly):
    @staticmethod
    def forward(ctx, core0, core1, core2, idx, offsets, factors, dim):
        fn = tt_lookup_cuda if _on_cuda(core0) else tt_lookup_ref
        return fn(core0, core1, core2, idx, offsets, factors, dim)


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


def qrobe_lookup(codes: torch.Tensor, scale: torch.Tensor, rows: torch.Tensor,
                 table_ids, dim: int, spec: RobeSpec, group_log2: int, *,
                 delta: torch.Tensor | None = None) -> torch.Tensor:
    """[B, F] int32 rows -> [B, F, dim] embeddings dequantized from the int8
    ROBE array ``codes`` against per-group ``scale``, in ``scale``'s dtype
    (one rounding).  Given the f32 ``delta`` array, plus its ROBE lookup
    ``delta[slot] · sign`` rounded into that dtype (the qrobe backend's
    straight-through term), in the same launch on the card."""
    return _QrobeLookup.apply(codes, scale, rows, tuple(table_ids), dim, spec,
                              group_log2, delta)


def qr_lookup(q_table: torch.Tensor, r_table: torch.Tensor, idx: torch.Tensor,
              q_off, r_off, m: int) -> torch.Tensor:
    """[B, F] int32 ids -> [B, F, dim] as ``Q[id // m + q_off[f]] *
    R[id % m + r_off[f]]``, in ``q_table``'s dtype."""
    return _QrLookup.apply(q_table, r_table, idx, tuple(q_off), tuple(r_off),
                           m)


def tt_lookup(core0: torch.Tensor, core1: torch.Tensor, core2: torch.Tensor,
              idx: torch.Tensor, offsets, factors, dim: int) -> torch.Tensor:
    """[B, F] int32 ids (+ per-field ``offsets``) -> [B, F, dim] by the chain
    G1[i1]·G2[i2]·G3[i3] over the mixed-radix split of the global row over
    ``factors`` = (n1, n2, n3), in the cores' dtype."""
    return _TtLookup.apply(core0, core1, core2, idx, tuple(offsets),
                           tuple(factors), dim)
