"""Hopper kernel for the quotient-remainder lookup, beside its plain
version.

``qr_lookup_cuda`` launches ``csrc/qr_lookup.cu`` (the port of
``qr_lookup_pallas``): [B, F] int32 ids -> [B, F, dim] embeddings
``Q[id // m + q_off[f]] * R[id % m + r_off[f]]`` in Q's dtype.
``qr_lookup_ref`` is the plain PyTorch version it is held against.

``qr_lookup_bwd_cuda`` launches ``csrc/qr_lookup_bwd.cu`` (the port of the
JAX package's ``_qr_bwd``): the cotangent [B, F, dim] -> (dQ, dR) by the
product rule, the items first sorted by the row they update
(``csrc/row_sort.cuh``), so that a row's items are summed before they
reach its atomics.  ``qr_lookup_bwd_ref`` is its plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import qr_lookup_bwd_ref, qr_lookup_ref

__all__ = ["qr_lookup_cuda", "qr_lookup_ref", "qr_lookup_bwd_cuda",
           "qr_lookup_bwd_ref"]


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


def qr_lookup_bwd_cuda(g: torch.Tensor, q_table: torch.Tensor,
                       r_table: torch.Tensor, idx: torch.Tensor, q_off,
                       r_off, m: int) -> tuple:
    """The lookup's cotangent g [B, F, dim] in the tables' dtype (any batch
    and field strides, elements contiguous), Q, R and the [B, F] int32 ids
    in [0, vocab), on one CUDA device -> (dQ, dR) in the tables' dtype,
    each row summed in f32 in no fixed order."""
    dev = q_table.device
    if not (g.is_cuda and q_table.device == g.device
            and r_table.device == dev and idx.device == dev):
        raise ValueError("qr_lookup_bwd_cuda needs g, Q, R and idx on one "
                         "CUDA device")
    if q_table.dim() != 2 or r_table.dim() != 2 or \
            r_table.shape[1] != q_table.shape[1] or \
            not (q_table.is_contiguous() and r_table.is_contiguous()):
        raise ValueError(f"Q and R must be contiguous [rows, dim] of one "
                         f"width, got {tuple(q_table.shape)} and "
                         f"{tuple(r_table.shape)}")
    if not (r_table.dtype == q_table.dtype == g.dtype):
        raise ValueError(f"g, Q and R must share a dtype, got {g.dtype}, "
                         f"{q_table.dtype} and {r_table.dtype}")
    if idx.dtype != torch.int32 or idx.dim() != 2 or \
            not idx.is_contiguous():
        raise ValueError(f"idx must be contiguous [B, F] int32, got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    b, f = idx.shape
    dim = q_table.shape[1]
    if g.shape != (b, f, dim) or g.stride(2) != 1:
        raise ValueError(f"g must be [{b}, {f}, {dim}] with contiguous "
                         f"elements, got {tuple(g.shape)} strides "
                         f"{g.stride()}")
    qo, ro = tuple(int(o) for o in q_off), tuple(int(o) for o in r_off)
    if len(qo) != f or len(ro) != f:
        raise ValueError(f"{len(qo)} / {len(ro)} offsets for {f} fields")
    if not 0 < m < 2 ** 31:
        raise ValueError(f"m must be a positive int32, got {m}")
    n_q, n_r = q_table.shape[0], r_table.shape[0]
    if max(n_q, n_r) >= 2 ** 31 or b * f >= 2 ** 31:
        raise ValueError(f"unsupported shape: B*F = {b * f}, tables of "
                         f"{n_q} and {n_r} rows")
    code = _build.dtype_code(g)
    ws_q = torch.zeros(q_table.shape, dtype=torch.float32, device=dev)
    ws_r = torch.zeros(r_table.shape, dtype=torch.float32, device=dev)
    f32 = g.dtype == torch.float32
    out_q = ws_q if f32 else torch.zeros(q_table.shape, dtype=g.dtype,
                                         device=dev)
    out_r = ws_r if f32 else torch.zeros(r_table.shape, dtype=g.dtype,
                                         device=dev)
    if b == 0 or n_q == 0 or n_r == 0:
        return out_q, out_r
    nbytes = _build.row_sort_bytes(max(n_q, n_r), b * f)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    err = _build.library().qr_lookup_bwd_launch(
        g.data_ptr(), q_table.data_ptr(), r_table.data_ptr(), idx.data_ptr(),
        ws_q.data_ptr(), ws_r.data_ptr(), out_q.data_ptr(), out_r.data_ptr(),
        scratch.data_ptr(), nbytes, b * f, code, g.stride(0), g.stride(1),
        _build.field_args(qo), _build.field_args(ro), f, m, dim, n_q, n_r,
        _build.stream_ptr(g))
    _build.check("qr_lookup_bwd", err)
    qr_lookup_bwd_cuda.launches += 1
    return out_q, out_r


qr_lookup_bwd_cuda.launches = 0
