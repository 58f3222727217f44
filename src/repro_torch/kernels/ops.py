"""The port's public ops, dispatched by device.

A CUDA tensor goes to the Hopper kernel, a CPU tensor to the plain
version, and any other device raises: nothing falls back.  (The JAX
package chose by ``jax.default_backend()`` and a ``use_kernel`` flag; here
``use_kernel`` only chooses the fused serve path or the unfused one, in
``models/recsys.py``.)

Each op is a ``torch.autograd.Function`` with the backward of the JAX
package's custom VJP, dispatched by device like its forward.  On the card
the backwards are Hopper kernels: ``robe_lookup_bwd`` (the sign-corrected
scatter-add into M), ``dot_interaction_bwd``, ``qrobe_lookup_bwd`` (the
scales' and the ``delta`` carrier's gradients; the int8 codes take none),
``qr_lookup_bwd`` and ``tt_lookup_bwd``; ``serve_fused``'s backward is
composed of ``robe_lookup``, ``dot_interaction_bwd`` and
``robe_lookup_bwd``.  The serve path runs under ``torch.inference_mode()``;
an op saves its backward's inputs only when an input needs a gradient, and
returns ``None`` for the integer inputs and the static arguments.
"""

from __future__ import annotations

import torch

from repro_torch.core.robe import RobeSpec
from repro_torch.kernels.dot_interaction import (dot_interaction_bwd_cuda,
                                                 dot_interaction_bwd_ref,
                                                 dot_interaction_cuda,
                                                 dot_interaction_ref)
from repro_torch.kernels.qr_lookup import (qr_lookup_bwd_cuda,
                                           qr_lookup_bwd_ref, qr_lookup_cuda,
                                           qr_lookup_ref)
from repro_torch.kernels.qrobe_lookup import (qrobe_lookup_bwd_cuda,
                                              qrobe_lookup_bwd_ref,
                                              qrobe_lookup_cuda,
                                              qrobe_lookup_ref)
from repro_torch.kernels.robe_lookup import (robe_lookup_bwd_cuda,
                                             robe_lookup_bwd_ref,
                                             robe_lookup_cuda, robe_lookup_ref)
from repro_torch.kernels.serve_fused import (serve_fused_bwd_cuda,
                                             serve_fused_bwd_ref,
                                             serve_fused_cuda, serve_fused_ref)
from repro_torch.kernels.tt_lookup import (tt_lookup_bwd_cuda,
                                           tt_lookup_bwd_ref, tt_lookup_cuda,
                                           tt_lookup_ref)

__all__ = ["robe_lookup", "dot_interaction", "serve_fused", "qrobe_lookup",
           "qr_lookup", "tt_lookup"]


def _on_cuda(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def _grad_in(g: torch.Tensor) -> torch.Tensor:
    """A cotangent as the backward kernels take it: elements contiguous
    (any batch and field strides)."""
    return g if g.stride(-1) == 1 else g.contiguous()


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
            fn, g = robe_lookup_bwd_cuda, _grad_in(g)
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


class _ServeFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, memory, idx, bot, table_ids, dim, spec):
        fn = serve_fused_cuda if _on_cuda(memory) else serve_fused_ref
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[2]:
            ctx.save_for_backward(memory, idx, bot)
            ctx.args = (table_ids, dim, spec)
        return fn(memory, idx, bot, table_ids, dim, spec)

    @staticmethod
    def backward(ctx, g):
        memory, idx, bot = ctx.saved_tensors
        fn = serve_fused_bwd_cuda if _on_cuda(g) else serve_fused_bwd_ref
        gm, gbot = fn(g, memory, idx, bot, *ctx.args)
        return (gm if ctx.needs_input_grad[0] else None, None,
                gbot if ctx.needs_input_grad[2] else None, None, None, None)


class _QrobeLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, codes, scale, rows, table_ids, dim, spec, group_log2,
                delta):
        fn = qrobe_lookup_cuda if _on_cuda(codes) else qrobe_lookup_ref
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[7]:
            ctx.save_for_backward(codes, rows)
            ctx.args = (table_ids, dim, spec, group_log2, scale.dtype)
        return fn(codes, scale, rows, table_ids, dim, spec, group_log2,
                  delta)

    @staticmethod
    def backward(ctx, g):
        codes, rows = ctx.saved_tensors
        table_ids, dim, spec, group_log2, scale_dtype = ctx.args
        if _on_cuda(g):
            fn, g = qrobe_lookup_bwd_cuda, _grad_in(g)
        else:
            fn = qrobe_lookup_bwd_ref
        gscale, gdelta = fn(g.to(scale_dtype), codes, rows, table_ids, dim,
                            spec, group_log2)
        return (None, gscale if ctx.needs_input_grad[1] else None, None,
                None, None, None, None,
                gdelta if ctx.needs_input_grad[7] else None)


class _QrLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q_table, r_table, idx, q_off, r_off, m):
        fn = qr_lookup_cuda if _on_cuda(q_table) else qr_lookup_ref
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            ctx.save_for_backward(q_table, r_table, idx)
            ctx.args = (q_off, r_off, m)
        return fn(q_table, r_table, idx, q_off, r_off, m)

    @staticmethod
    def backward(ctx, g):
        q_table, r_table, idx = ctx.saved_tensors
        if _on_cuda(g):
            fn, g = qr_lookup_bwd_cuda, _grad_in(g)
        else:
            fn = qr_lookup_bwd_ref
        gq, gr = fn(g.to(q_table.dtype), q_table, r_table, idx, *ctx.args)
        return (gq if ctx.needs_input_grad[0] else None,
                gr if ctx.needs_input_grad[1] else None,
                None, None, None, None)


class _TtLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, core0, core1, core2, idx, offsets, factors, dim):
        fn = tt_lookup_cuda if _on_cuda(core0) else tt_lookup_ref
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(core0, core1, core2, idx)
            ctx.args = (offsets, factors)
        return fn(core0, core1, core2, idx, offsets, factors, dim)

    @staticmethod
    def backward(ctx, g):
        core0, core1, core2, idx = ctx.saved_tensors
        if _on_cuda(g):
            fn, g = tt_lookup_bwd_cuda, _grad_in(g)
        else:
            fn = tt_lookup_bwd_ref
        grads = fn(g.to(core0.dtype), core0, core1, core2, idx, *ctx.args)
        return tuple(gc if need else None for gc, need in
                     zip(grads, ctx.needs_input_grad[:3])) + \
            (None, None, None, None)


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
