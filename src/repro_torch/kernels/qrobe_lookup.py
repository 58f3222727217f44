"""Hopper kernel for the int8 ROBE lookup, beside its plain version.

``qrobe_lookup_cuda`` launches ``csrc/qrobe_lookup.cu`` (the port of
``qrobe_lookup_pallas``): [B, F] int32 rows -> [B, F, dim] embeddings,
int8 codes gathered through the ROBE hash and dequantized against their
group's scale, in the scale's dtype.  Given the f32 ``delta`` array, the
same launch adds the qrobe backend's straight-through term
``delta[slot] · sign``.  ``qrobe_lookup_ref`` (plus, with ``delta``,
``robe_lookup_ref`` of ``delta`` and the add) is the plain PyTorch version
it is held against.
"""

from __future__ import annotations

import torch

from repro_torch.core.robe import RobeSpec
from repro_torch.kernels import _build
from repro_torch.kernels.ref import qrobe_lookup_ref

__all__ = ["qrobe_lookup_cuda", "qrobe_lookup_ref"]


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
