"""Hopper one-pass serve kernel, beside its plain version.

``serve_fused_cuda`` launches ``csrc/serve_fused.cu`` (the port of
``serve_fused_pallas``): ROBE lookup of every field -> -1-masked bag
pooling in f32 -> one rounding to ``bot``'s dtype -> the strict-lower gram
triangle of [bot; pooled], [B, (F+1)·F/2] in ``bot``'s dtype, with no
[B, F, D] intermediate in device memory.  ``serve_fused_ref`` is the plain
version.

``serve_fused_bwd_cuda`` is the op's backward on the card (the port of the
JAX package's ``_serve_bwd``), composed of three of the port's own Hopper
kernels, each counting its own launch: ``robe_lookup_cuda`` over the
bag-expanded rows recomputes the pooled features (then a masked bag sum),
``dot_interaction_bwd_cuda`` applies the gram transpose to [bot; pooled]
in f32 (which gives ``dbot``), and ``robe_lookup_bwd_cuda`` scatters the
pooled rows' cotangent, broadcast over each bag, into M: a -1 pad reads
and scatters row 0 with a zero cotangent, which adds nothing.
``serve_fused_bwd_ref`` is its plain version.
"""

from __future__ import annotations

import torch

from repro_torch.core.robe import RobeSpec
from repro_torch.kernels import _build
from repro_torch.kernels.dot_interaction import dot_interaction_bwd_cuda
from repro_torch.kernels.ref import serve_fused_bwd_ref, serve_fused_ref
from repro_torch.kernels.robe_lookup import (robe_lookup_bwd_cuda,
                                             robe_lookup_cuda)

__all__ = ["serve_fused_cuda", "serve_fused_ref", "serve_fused_bwd_cuda",
           "serve_fused_bwd_ref"]


def serve_fused_cuda(memory: torch.Tensor, idx: torch.Tensor,
                     bot: torch.Tensor, table_ids, dim: int,
                     spec: RobeSpec) -> torch.Tensor:
    """idx [B, F] or [B, F, bag] int32 (-1 = pad), bot [B, dim], memory
    [|M|], all on one CUDA device -> [B, (F+1)·F/2] in ``bot``'s dtype."""
    if not (memory.is_cuda and idx.device == memory.device
            and bot.device == memory.device):
        raise ValueError("serve_fused_cuda needs memory, idx and bot on one "
                         "CUDA device")
    if memory.dim() != 1 or memory.shape[0] != spec.size:
        raise ValueError(f"memory must be [{spec.size}], got "
                         f"{tuple(memory.shape)}")
    if idx.dim() == 2:
        idx = idx[..., None]
    if idx.dtype != torch.int32 or idx.dim() != 3:
        raise ValueError(f"idx must be [B, F(, bag)] int32, got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    b, f, bag = idx.shape
    if bot.shape != (b, dim):
        raise ValueError(f"bot must be [{b}, {dim}], got {tuple(bot.shape)}")
    if not (memory.is_contiguous() and idx.is_contiguous()
            and bot.is_contiguous()):
        raise ValueError("serve_fused_cuda takes contiguous tensors")
    tids = tuple(int(t) for t in table_ids)
    if len(tids) != f:
        raise ValueError(f"{len(tids)} table ids for {f} fields")
    if b * f * bag >= 2 ** 31:
        raise ValueError(f"batch too large for one launch: {b}x{f}x{bag}")
    mem_code, bot_code = _build.dtype_code(memory), _build.dtype_code(bot)
    out = torch.empty((b, (f + 1) * f // 2), dtype=bot.dtype,
                      device=bot.device)
    if b == 0:
        return out
    coeffs, tid_arr = _build.hash_args(spec, tids)
    err = _build.library().serve_fused_launch(
        memory.data_ptr(), idx.data_ptr(), bot.data_ptr(), out.data_ptr(),
        b, bag, mem_code, bot_code, coeffs, tid_arr, f, dim, spec.log2_z,
        int(spec.use_sign), _build.stream_ptr(memory))
    _build.check("serve_fused", err)
    serve_fused_cuda.launches += 1
    return out


serve_fused_cuda.launches = 0


def serve_fused_bwd_cuda(g: torch.Tensor, memory: torch.Tensor,
                         idx: torch.Tensor, bot: torch.Tensor, table_ids,
                         dim: int, spec: RobeSpec) -> tuple:
    """The op's cotangent g [B, (F+1)·F/2], with memory [|M|], idx [B, F]
    or [B, F, bag] int32 (-1 = pad) and bot [B, dim] on one CUDA device ->
    (gM [|M|] in M's dtype, gbot [B, dim] in bot's dtype)."""
    if not (g.is_cuda and memory.device == g.device
            and idx.device == g.device and bot.device == g.device):
        raise ValueError("serve_fused_bwd_cuda needs g, memory, idx and bot "
                         "on one CUDA device")
    if idx.dim() == 2:
        idx = idx[..., None]
    if idx.dtype != torch.int32 or idx.dim() != 3:
        raise ValueError(f"idx must be [B, F(, bag)] int32, got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    b, f, bag = idx.shape
    if g.shape != (b, (f + 1) * f // 2) or bot.shape != (b, dim):
        raise ValueError(f"g must be [{b}, {(f + 1) * f // 2}] and bot "
                         f"[{b}, {dim}], got {tuple(g.shape)} and "
                         f"{tuple(bot.shape)}")
    if b == 0:
        return torch.zeros_like(memory), torch.zeros_like(bot)
    mask = idx >= 0
    # the bag-expanded rows [B*bag, F], a pad read (and scattered) as row 0
    rows = torch.where(mask, idx, torch.zeros_like(idx)).permute(
        0, 2, 1).reshape(b * bag, f).contiguous()
    keep = mask.permute(0, 2, 1)[..., None]             # [B, bag, F, 1]
    emb = robe_lookup_cuda(memory, rows, table_ids, dim, spec)
    pooled = (emb.view(b, bag, f, dim).to(torch.float32) * keep).sum(dim=1)
    feats = torch.cat([bot[:, None, :].to(torch.float32),
                       pooled.to(bot.dtype).to(torch.float32)], dim=1)
    dfeats = dot_interaction_bwd_cuda(g.to(torch.float32).contiguous(),
                                      feats, False)     # [B, F+1, dim] f32
    dpool = (dfeats[:, None, 1:, :] * keep).reshape(b * bag, f, dim)
    gm = robe_lookup_bwd_cuda(dpool, rows, table_ids, dim, spec)
    return gm.to(memory.dtype), dfeats[:, 0].to(bot.dtype)
