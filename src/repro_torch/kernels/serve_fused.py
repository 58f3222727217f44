"""Hopper one-pass serve kernel, beside its plain version.

``serve_fused_cuda`` launches ``csrc/serve_fused.cu`` (the port of
``serve_fused_pallas``): ROBE lookup of every field -> -1-masked bag
pooling in f32 -> one rounding to ``bot``'s dtype -> the strict-lower gram
triangle of [bot; pooled], [B, (F+1)·F/2] in ``bot``'s dtype, with no
[B, F, D] intermediate in device memory.  ``serve_fused_ref`` is the plain
version.
"""

from __future__ import annotations

import torch

from repro_torch.core.robe import RobeSpec
from repro_torch.kernels import _build
from repro_torch.kernels.ref import serve_fused_ref

__all__ = ["serve_fused_cuda", "serve_fused_ref"]


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
