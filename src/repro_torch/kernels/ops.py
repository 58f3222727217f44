"""The port's public ops, dispatched by device.

A CUDA tensor goes to the Hopper kernel, a CPU tensor to the plain
version, and any other device raises: nothing falls back.  (The JAX
package chose by ``jax.default_backend()`` and a ``use_kernel`` flag; here
``use_kernel`` only chooses the fused serve path or the unfused one, in
``models/recsys.py``.)

Each op is a ``torch.autograd.Function``.  ``robe_lookup`` and
``dot_interaction``, the two ops of the DLRM's training step, have the
backwards of the JAX package's custom VJPs, dispatched by device like
their forwards: on the card the Hopper kernels ``robe_lookup_bwd`` (the
sign-corrected scatter-add into M) and ``dot_interaction_bwd``.
``serve_fused``, ``qrobe_lookup``, ``qr_lookup`` and ``tt_lookup`` are
forward only: their backwards raise ``NotImplementedError`` and come with
the next slice of the port, which trains the compressed substrates.  The
serve path runs under ``torch.inference_mode()``; an op saves its
backward's inputs only when its first input needs a gradient.
"""

from __future__ import annotations

import torch

from repro_torch.core.robe import RobeSpec
from repro_torch.kernels.dot_interaction import (dot_interaction_bwd_cuda,
                                                 dot_interaction_bwd_ref,
                                                 dot_interaction_cuda,
                                                 dot_interaction_ref)
from repro_torch.kernels.qr_lookup import qr_lookup_cuda, qr_lookup_ref
from repro_torch.kernels.qrobe_lookup import (qrobe_lookup_cuda,
                                              qrobe_lookup_ref)
from repro_torch.kernels.robe_lookup import (robe_lookup_bwd_cuda,
                                             robe_lookup_bwd_ref,
                                             robe_lookup_cuda, robe_lookup_ref)
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


#: the slice of the port that brings each missing backward
LATER = {
    "qrobe_lookup": "the next slice, which trains the compressed substrates",
    "qr_lookup": "the next slice, which trains the compressed substrates",
    "tt_lookup": "the next slice, which trains the compressed substrates",
    "serve_fused": "the slice after the compressed substrates' training "
                   "(the JAX package's _serve_bwd)",
}


class _ForwardOnly(torch.autograd.Function):
    """An op whose backward the port does not have yet; its forward sets
    ``ctx.op_name``."""

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            f"the backward of {ctx.op_name} is not yet ported: it comes with "
            f"{LATER[ctx.op_name]} (ROADMAP module item 1)")


class _RobeLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, memory, rows, table_ids, dim, spec):
        fn = robe_lookup_cuda if _on_cuda(memory) else robe_lookup_ref
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(rows)
            ctx.args = (table_ids, dim, spec, memory.dtype)
        return fn(memory, rows, table_ids, dim, spec)

    @staticmethod
    def backward(ctx, g):
        (rows,) = ctx.saved_tensors
        table_ids, dim, spec, mem_dtype = ctx.args
        if _on_cuda(g):
            fn = robe_lookup_bwd_cuda
            if g.stride(-1) != 1:
                g = g.contiguous()
        else:
            fn = robe_lookup_bwd_ref
        gm = fn(g.to(mem_dtype), rows, table_ids, dim, spec)
        return gm, None, None, None, None


class _DotInteraction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, self_interaction):
        fn = dot_interaction_cuda if _on_cuda(feats) else dot_interaction_ref
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(feats)
            ctx.self_interaction = self_interaction
        return fn(feats, self_interaction)

    @staticmethod
    def backward(ctx, g):
        (feats,) = ctx.saved_tensors
        if _on_cuda(g):
            fn = dot_interaction_bwd_cuda
            if g.dim() == 2 and g.shape[1] > 1 and g.stride(1) != 1:
                g = g.contiguous()
        else:
            fn = dot_interaction_bwd_ref
        return fn(g.to(feats.dtype), feats, ctx.self_interaction), None


class _ServeFused(_ForwardOnly):
    @staticmethod
    def forward(ctx, memory, idx, bot, table_ids, dim, spec):
        ctx.op_name = "serve_fused"
        fn = serve_fused_cuda if _on_cuda(memory) else serve_fused_ref
        return fn(memory, idx, bot, table_ids, dim, spec)


class _QrobeLookup(_ForwardOnly):
    @staticmethod
    def forward(ctx, codes, scale, rows, table_ids, dim, spec, group_log2,
                delta):
        ctx.op_name = "qrobe_lookup"
        fn = qrobe_lookup_cuda if _on_cuda(codes) else qrobe_lookup_ref
        return fn(codes, scale, rows, table_ids, dim, spec, group_log2,
                  delta)


class _QrLookup(_ForwardOnly):
    @staticmethod
    def forward(ctx, q_table, r_table, idx, q_off, r_off, m):
        ctx.op_name = "qr_lookup"
        fn = qr_lookup_cuda if _on_cuda(q_table) else qr_lookup_ref
        return fn(q_table, r_table, idx, q_off, r_off, m)


class _TtLookup(_ForwardOnly):
    @staticmethod
    def forward(ctx, core0, core1, core2, idx, offsets, factors, dim):
        ctx.op_name = "tt_lookup"
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
