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
gradient, ``delta``'s gradient).  Its (item, segment) pairs are ordered by
band of their first slot (``bwd_plan`` sizes the scratch); a warp sums a
band's pairs in registers and sends each run's sums once into ``delta``'s
gradient and, times the codes, into the scales'.
``qrobe_lookup_bwd_ref`` is its plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.robe import RobeSpec
from repro_torch.kernels import _build
from repro_torch.kernels.ref import qrobe_lookup_bwd_ref, qrobe_lookup_ref

__all__ = ["qrobe_lookup_cuda", "qrobe_lookup_ref", "qrobe_lookup_bwd_cuda",
           "qrobe_lookup_bwd_ref", "bwd_plan"]

#: slots a band of the backward's order spans, log2 (kBandLog2 in
#: csrc/qrobe_lookup_bwd.cu): a pair's W <= 32 slots start in one band, so
#: a band's pairs update one window of 64 slots, two registers a lane
BAND_LOG2 = 5
#: the longest run of elements a pair covers, log2 (kSegLog2): one warp
MAX_SEG_LOG2 = 5


class QrobeBwdPlan(NamedTuple):
    """What ``qrobe_lookup_bwd.cu``'s launcher derives from the shapes."""
    seg_log2: int     # a pair's run of elements: W = 2^seg_log2 <= Z, 32
    n_seg: int        # pairs an item can span
    n_bands: int      # ceil(|M| / 2^BAND_LOG2)
    scan_tiles: int   # tiles of _build.SORT_TILE bands the scan takes
    n_groups: int     # scale groups, ceil(|M| / 2^group_log2)
    scratch_bytes: int


def bwd_plan(spec: RobeSpec, n_items: int, dim: int,
             group_log2: int) -> QrobeBwdPlan:
    """The backward's plan for ``n_items`` (row, field) items at width
    ``dim``: an item's elements are cut into pairs, runs of at most W =
    min(Z, 32) elements aligned to W (so each lies in one ROBE block), and
    the pairs ordered by band of 2^BAND_LOG2 slots of their first slot.
    The scratch holds a count (then an end) a band, a sum a tile of the
    scan, each pair's index in band order (4 bytes) and the scales' f32
    sums, every part 256-byte aligned."""
    lw = min(spec.log2_z, MAX_SEG_LOG2)
    w = 1 << lw
    if dim % w == 0:
        n_seg = dim // w
    elif w % dim == 0:
        n_seg = 1
    else:
        n_seg = ((dim - 1) >> lw) + 2
    n_bands = ((spec.size - 1) >> BAND_LOG2) + 1
    tiles = -(-n_bands // _build.SORT_TILE)
    n_groups = ((spec.size - 1) >> group_log2) + 1
    scratch = _build.align(4 * n_bands) + _build.align(4 * tiles) \
        + _build.align(4 * n_items * n_seg) + _build.align(4 * n_groups)
    return QrobeBwdPlan(lw, n_seg, n_bands, tiles, n_groups, scratch)


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
    plan = bwd_plan(spec, b * f, dim, group_log2)
    if b * f * plan.n_seg >= 2 ** 31:
        raise ValueError(f"too many (item, segment) pairs for one launch: "
                         f"{b * f} items of {plan.n_seg}")
    code = _build.dtype_code(g)
    gdelta = torch.zeros(spec.size, dtype=torch.float32, device=g.device)
    # f32 scales are summed in place; bf16 ones are written from the f32
    # sums in the scratch
    gscale = (torch.zeros if g.dtype == torch.float32 else torch.empty)(
        plan.n_groups, dtype=g.dtype, device=g.device)
    if b == 0:
        return gscale.zero_(), gdelta
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
