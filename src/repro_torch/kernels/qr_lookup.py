"""Hopper kernel for the quotient-remainder lookup, beside its plain
version.

``qr_lookup_cuda`` launches ``csrc/qr_lookup.cu`` (the port of
``qr_lookup_pallas``): [B, F] int32 ids -> [B, F, dim] embeddings
``Q[id // m + q_off[f]] * R[id % m + r_off[f]]`` in Q's dtype.
``qr_lookup_ref`` is the plain PyTorch version it is held against.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import qr_lookup_ref

__all__ = ["qr_lookup_cuda", "qr_lookup_ref"]


def qr_lookup_cuda(q_table: torch.Tensor, r_table: torch.Tensor,
                   idx: torch.Tensor, q_off, r_off, m: int) -> torch.Tensor:
    """Q [sum q_rows, dim], R [m·F, dim] of one dtype and [B, F] int32 ids
    in [0, vocab), all on one CUDA device -> [B, F, dim] in Q's dtype."""
    if not (q_table.is_cuda and r_table.device == q_table.device
            and idx.device == q_table.device):
        raise ValueError("qr_lookup_cuda needs Q, R and idx on one CUDA "
                         "device")
    if q_table.dim() != 2 or r_table.dim() != 2 or \
            r_table.shape[1] != q_table.shape[1]:
        raise ValueError(f"Q and R must be [rows, dim] of one width, got "
                         f"{tuple(q_table.shape)} and {tuple(r_table.shape)}")
    if r_table.dtype != q_table.dtype:
        raise ValueError(f"Q and R must share a dtype, got {q_table.dtype} "
                         f"and {r_table.dtype}")
    if idx.dtype != torch.int32 or idx.dim() != 2:
        raise ValueError(f"idx must be [B, F] int32, got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if not (q_table.is_contiguous() and r_table.is_contiguous()
            and idx.is_contiguous()):
        raise ValueError("qr_lookup_cuda takes contiguous tensors")
    b, f = idx.shape
    qo, ro = tuple(int(o) for o in q_off), tuple(int(o) for o in r_off)
    if len(qo) != f or len(ro) != f:
        raise ValueError(f"{len(qo)} / {len(ro)} offsets for {f} fields")
    if not 0 < m < 2 ** 31:
        raise ValueError(f"m must be a positive int32, got {m}")
    # every row the kernel can address, offset included, fits an int32
    if max(q_table.shape[0], r_table.shape[0]) >= 2 ** 31:
        raise ValueError("tables of 2^31 rows or more")
    if b * f >= 2 ** 31:
        raise ValueError(f"batch too large for one launch: B*F = {b * f}")
    dim = q_table.shape[1]
    code = _build.dtype_code(q_table)
    out = torch.empty((b, f, dim), dtype=q_table.dtype, device=q_table.device)
    if b == 0:
        return out
    err = _build.library().qr_lookup_launch(
        q_table.data_ptr(), r_table.data_ptr(), idx.data_ptr(),
        out.data_ptr(), b * f, code, _build.field_args(qo),
        _build.field_args(ro), f, m, dim, _build.stream_ptr(q_table))
    _build.check("qr_lookup", err)
    qr_lookup_cuda.launches += 1
    return out


qr_lookup_cuda.launches = 0
