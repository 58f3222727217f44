"""Hopper kernels for the ROBE lookup and its backward, beside their plain
versions.

``robe_lookup_cuda`` launches ``csrc/robe_lookup.cu`` (the port of
``robe_lookup_pallas``): [B, F] int32 rows -> [B, F, dim] embeddings in M's
dtype, hashed and gathered in one pass.  ``robe_lookup_bwd_cuda`` launches
``csrc/robe_lookup_bwd.cu`` (the port of the JAX package's ``_lookup_bwd``):
the cotangent [B, F, dim] -> gM [|M|], the sign-corrected scatter-add into
the slots the forward read, by f32 atomics.  ``robe_lookup_ref`` and
``robe_lookup_bwd_ref`` are the plain PyTorch versions they are held
against.
"""

from __future__ import annotations

import torch

from repro_torch.core.robe import RobeSpec
from repro_torch.kernels import _build
from repro_torch.kernels.ref import robe_lookup_bwd_ref, robe_lookup_ref

__all__ = ["robe_lookup_cuda", "robe_lookup_ref", "robe_lookup_bwd_cuda",
           "robe_lookup_bwd_ref"]


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


def robe_lookup_bwd_cuda(g: torch.Tensor, rows: torch.Tensor, table_ids,
                         dim: int, spec: RobeSpec) -> torch.Tensor:
    """The lookup's cotangent g [B, F, dim] on the card (any batch and field
    strides, elements contiguous) -> gM [|M|] in ``g``'s dtype, summed in
    f32 in no fixed order."""
    if not (g.is_cuda and rows.device == g.device):
        raise ValueError("robe_lookup_bwd_cuda needs g and rows on one CUDA "
                         "device")
    if rows.dtype != torch.int32 or rows.dim() != 2 or \
            not rows.is_contiguous():
        raise ValueError(f"rows must be contiguous [B, F] int32, got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    b, f = rows.shape
    if g.shape != (b, f, dim) or g.stride(2) != 1:
        raise ValueError(f"g must be [{b}, {f}, {dim}] with contiguous "
                         f"elements, got {tuple(g.shape)} strides "
                         f"{g.stride()}")
    tids = tuple(int(t) for t in table_ids)
    if len(tids) != f:
        raise ValueError(f"{len(tids)} table ids for {f} fields")
    if dim < 1 or b * f >= 2 ** 31:
        raise ValueError(f"unsupported shape: B*F = {b * f}, dim = {dim}")
    code = _build.dtype_code(g)
    ws = torch.zeros(spec.size, dtype=torch.float32, device=g.device)
    out = ws if g.dtype == torch.float32 else \
        torch.empty(spec.size, dtype=g.dtype, device=g.device)
    if b == 0:
        return out.zero_()
    coeffs, tid_arr = _build.hash_args(spec, tids)
    err = _build.library().robe_lookup_bwd_launch(
        g.data_ptr(), rows.data_ptr(), ws.data_ptr(), out.data_ptr(), b * f,
        code, g.stride(0), g.stride(1), coeffs, tid_arr, f, dim, spec.log2_z,
        int(spec.use_sign), _build.stream_ptr(g))
    _build.check("robe_lookup_bwd", err)
    robe_lookup_bwd_cuda.launches += 1
    return out


robe_lookup_bwd_cuda.launches = 0
