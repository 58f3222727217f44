"""Hopper kernel for the int8 ROBE lookup, beside its plain version.

``qrobe_lookup_cuda`` launches ``csrc/qrobe_lookup.cu`` (the port of
``qrobe_lookup_pallas``): [B, F] int32 rows -> [B, F, dim] embeddings,
int8 codes gathered through the ROBE hash and dequantized against their
group's scale, in the scale's dtype.  Given the f32 ``delta`` array, the
same launch adds the qrobe backend's straight-through term
``delta[slot] · sign``.  ``qrobe_lookup_ref`` (plus, with ``delta``,
``robe_lookup_ref`` of ``delta`` and the add) is the plain PyTorch version
it is held against.

``qrobe_lookup_bwd_cuda`` launches ``csrc/qrobe_lookup_bwd.cu`` (the port
of the JAX package's ``_qrobe_bwd`` and of the gradient its autodiff gives
the backend's ``delta`` term): the cotangent [B, F, dim] -> (the scales'
gradient, ``delta``'s gradient), the second by ``robe_lookup_bwd``'s
bucketed scatter of ``g · sign`` into an f32 workspace, the first summed
from it (``code · gdelta`` over each group) in one more pass.
``qrobe_lookup_bwd_ref`` is its plain version.
"""

from __future__ import annotations

import torch

from repro_torch.core.robe import RobeSpec
from repro_torch.kernels import _build
from repro_torch.kernels.ref import qrobe_lookup_bwd_ref, qrobe_lookup_ref
from repro_torch.kernels.robe_lookup import STAGE_PAIRS, bwd_plan

__all__ = ["qrobe_lookup_cuda", "qrobe_lookup_ref", "qrobe_lookup_bwd_cuda",
           "qrobe_lookup_bwd_ref"]


def qrobe_lookup_cuda(codes: torch.Tensor, scale: torch.Tensor,
                      rows: torch.Tensor, table_ids, dim: int,
                      spec: RobeSpec, group_log2: int,
                      delta: torch.Tensor | None = None) -> torch.Tensor:
    """codes [|M|] int8, scale [ceil(|M| / 2^group_log2)], [B, F] int32 rows
    and, if given, delta [|M|] f32, all on one CUDA device -> [B, F, dim]
    in ``scale``'s dtype."""
    if delta is not None and not (
            delta.device == codes.device and delta.dtype == torch.float32
            and delta.dim() == 1 and delta.shape[0] == spec.size
            and delta.is_contiguous()):
        raise ValueError(f"delta must be a contiguous [{spec.size}] float32 "
                         f"tensor on {codes.device}, got {delta.dtype} "
                         f"{tuple(delta.shape)} on {delta.device}")
    if not (codes.is_cuda and scale.device == codes.device
            and rows.device == codes.device):
        raise ValueError("qrobe_lookup_cuda needs codes, scale and rows on "
                         "one CUDA device")
    if codes.dtype != torch.int8 or codes.dim() != 1 or \
            codes.shape[0] != spec.size:
        raise ValueError(f"codes must be [{spec.size}] int8, got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    if not 0 <= group_log2 <= 30:
        raise ValueError(f"group_log2 must be in [0, 30], got {group_log2}")
    n_groups = -(-spec.size // (1 << group_log2))
    if scale.dim() != 1 or scale.shape[0] != n_groups:
        raise ValueError(f"scale must be [{n_groups}], got "
                         f"{tuple(scale.shape)}")
    if rows.dtype != torch.int32 or rows.dim() != 2:
        raise ValueError(f"rows must be [B, F] int32, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if not (codes.is_contiguous() and scale.is_contiguous()
            and rows.is_contiguous()):
        raise ValueError("qrobe_lookup_cuda takes contiguous tensors")
    if dim < 1:
        raise ValueError(f"dim must be positive, got {dim}")
    b, f = rows.shape
    tids = tuple(int(t) for t in table_ids)
    if len(tids) != f:
        raise ValueError(f"{len(tids)} table ids for {f} fields")
    if b * f >= 2 ** 31:
        raise ValueError(f"batch too large for one launch: B*F = {b * f}")
    code = _build.dtype_code(scale)
    out = torch.empty((b, f, dim), dtype=scale.dtype, device=scale.device)
    if b == 0:
        return out
    coeffs, tid_arr = _build.hash_args(spec, tids)
    err = _build.library().qrobe_lookup_launch(
        codes.data_ptr(), scale.data_ptr(),
        None if delta is None else delta.data_ptr(), rows.data_ptr(),
        out.data_ptr(), b * f, code, coeffs, tid_arr, f, dim, spec.log2_z,
        int(spec.use_sign), group_log2, _build.stream_ptr(codes))
    _build.check("qrobe_lookup", err)
    qrobe_lookup_cuda.launches += 1
    return out


qrobe_lookup_cuda.launches = 0


def qrobe_lookup_bwd_cuda(g: torch.Tensor, codes: torch.Tensor,
                          rows: torch.Tensor, table_ids, dim: int,
                          spec: RobeSpec, group_log2: int) -> tuple:
    """The lookup's cotangent g [B, F, dim] in the scale's dtype (any batch
    and field strides, elements contiguous), codes [|M|] int8 and the
    [B, F] int32 rows, on one CUDA device -> (gscale [ceil(|M| /
    2^group_log2)] in g's dtype, gdelta [|M|] f32), each summed in f32 in
    no fixed order."""
    if not (g.is_cuda and rows.device == g.device
            and codes.device == g.device):
        raise ValueError("qrobe_lookup_bwd_cuda needs g, codes and rows on "
                         "one CUDA device")
    if codes.dtype != torch.int8 or codes.shape != (spec.size,) or \
            not codes.is_contiguous():
        raise ValueError(f"codes must be contiguous [{spec.size}] int8, got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    if rows.dtype != torch.int32 or rows.dim() != 2 or \
            not rows.is_contiguous():
        raise ValueError(f"rows must be contiguous [B, F] int32, got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    b, f = rows.shape
    if g.shape != (b, f, dim) or g.stride(2) != 1:
        raise ValueError(f"g must be [{b}, {f}, {dim}] with contiguous "
                         f"elements, got {tuple(g.shape)} strides "
                         f"{g.stride()}")
    if not 0 <= group_log2 <= 30:
        raise ValueError(f"group_log2 must be in [0, 30], got {group_log2}")
    tids = tuple(int(t) for t in table_ids)
    if len(tids) != f:
        raise ValueError(f"{len(tids)} table ids for {f} fields")
    if dim < 1 or b * f >= 2 ** 31:
        raise ValueError(f"unsupported shape: B*F = {b * f}, dim = {dim}")
    plan = bwd_plan(spec, f, b * f, dim)
    if b * f * plan.n_seg >= 2 ** 31 or plan.n_seg > STAGE_PAIRS:
        raise ValueError(f"too many (item, segment) pairs for one launch: "
                         f"{b * f} items of {plan.n_seg}")
    code = _build.dtype_code(g)
    gdelta = torch.zeros(spec.size, dtype=torch.float32, device=g.device)
    gscale = torch.zeros(-(-spec.size // (1 << group_log2)), dtype=g.dtype,
                         device=g.device)
    if b == 0:
        return gscale, gdelta
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                          device=g.device)
    coeffs, tid_arr = _build.hash_args(spec, tids)
    err = _build.library().qrobe_lookup_bwd_launch(
        g.data_ptr(), rows.data_ptr(), codes.data_ptr(), gdelta.data_ptr(),
        gscale.data_ptr(), scratch.data_ptr(), plan.scratch_bytes, b * f,
        code, g.stride(0), g.stride(1), coeffs, tid_arr, f, dim, spec.log2_z,
        int(spec.use_sign), group_log2, _build.stream_ptr(g))
    _build.check("qrobe_lookup_bwd", err)
    qrobe_lookup_bwd_cuda.launches += 1
    return gscale, gdelta


qrobe_lookup_bwd_cuda.launches = 0
