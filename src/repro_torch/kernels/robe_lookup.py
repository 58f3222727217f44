"""Hopper kernel for the ROBE lookup, beside its plain version.

``robe_lookup_cuda`` launches ``csrc/robe_lookup.cu`` (the port of
``robe_lookup_pallas``): [B, F] int32 rows -> [B, F, dim] embeddings in M's
dtype, hashed and gathered in one pass.  ``robe_lookup_ref`` is the plain
PyTorch version it is held against.
"""

from __future__ import annotations

import torch

from repro_torch.core.robe import RobeSpec
from repro_torch.kernels import _build
from repro_torch.kernels.ref import robe_lookup_ref

__all__ = ["robe_lookup_cuda", "robe_lookup_ref"]


def robe_lookup_cuda(memory: torch.Tensor, rows: torch.Tensor, table_ids,
                     dim: int, spec: RobeSpec) -> torch.Tensor:
    """[B, F] int32 rows on the card -> [B, F, dim] in ``memory``'s dtype."""
    if not (memory.is_cuda and rows.device == memory.device):
        raise ValueError("robe_lookup_cuda needs memory and rows on one "
                         "CUDA device")
    if memory.dim() != 1 or memory.shape[0] != spec.size:
        raise ValueError(f"memory must be [{spec.size}], got "
                         f"{tuple(memory.shape)}")
    if rows.dtype != torch.int32 or rows.dim() != 2:
        raise ValueError(f"rows must be [B, F] int32, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if not (memory.is_contiguous() and rows.is_contiguous()):
        raise ValueError("robe_lookup_cuda takes contiguous tensors")
    if dim < 1:
        raise ValueError(f"dim must be positive, got {dim}")
    b, f = rows.shape
    tids = tuple(int(t) for t in table_ids)
    if len(tids) != f:
        raise ValueError(f"{len(tids)} table ids for {f} fields")
    if b * f >= 2 ** 31:
        raise ValueError(f"batch too large for one launch: B*F = {b * f}")
    code = _build.dtype_code(memory)
    out = torch.empty((b, f, dim), dtype=memory.dtype, device=memory.device)
    if b == 0:
        return out
    coeffs, tid_arr = _build.hash_args(spec, tids)
    lib = _build.library()
    err = lib.robe_lookup_launch(
        memory.data_ptr(), rows.data_ptr(), out.data_ptr(), b * f, code,
        coeffs, tid_arr, f, dim, spec.log2_z, int(spec.use_sign),
        _build.stream_ptr(memory))
    _build.check("robe_lookup", err)
    robe_lookup_cuda.launches += 1
    return out


robe_lookup_cuda.launches = 0
