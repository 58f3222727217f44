"""Hopper kernels for the ROBE lookup and its backward, beside their plain
versions.

``robe_lookup_cuda`` launches ``csrc/robe_lookup.cu`` (the port of
``robe_lookup_pallas``): [B, F] int32 rows -> [B, F, dim] embeddings in
M's dtype, hashed and gathered in one pass. ``robe_lookup_bwd_cuda``
launches ``csrc/robe_lookup_bwd.cu`` (the port of the JAX package's
``_lookup_bwd``): the cotangent [B, F, dim] -> gM [|M|], the sign-
corrected scatter-add into the slots the forward read, by f32 atomics,
its (item, segment) pairs first bucketed by band of M and field
(``bwd_plan`` sizes the scratch). ``robe_lookup_ref`` and
``robe_lookup_bwd_ref`` are the plain PyTorch versions they are held
against.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.robe import RobeSpec
from repro_torch.kernels import _build
from repro_torch.kernels.ref import robe_lookup_bwd_ref, robe_lookup_ref

__all__ = ["robe_lookup_cuda", "robe_lookup_ref", "robe_lookup_bwd_cuda",
           "robe_lookup_bwd_ref", "bwd_plan"]

#: slots of M a band of the backward's scatter spans, log2: 2^22 f32 slots
#: are 16 MiB, a third of the H100's 50 MB L2 (kBandLog2 in
#: csrc/robe_lookup_bwd.cu)
BAND_LOG2 = 22
#: most (band, field) buckets a launch sorts into (kMaxBuckets): the
#: bucketing passes keep one counter a bucket in shared memory
MAX_BUCKETS = 4096
#: the longest run of elements a pair covers, log2 (kSegLog2): one warp
MAX_SEG_LOG2 = 5
#: blocks of the bucketing passes at most, and their threads (kSortBlocks,
#: kSortThreads): each block counts and places one range of items
SORT_BLOCKS, SORT_THREADS = 256, 512
#: pairs a tile of the place pass orders in shared memory (kStagePairs):
#: an item may span no more
STAGE_PAIRS = 2048


class BwdPlan(NamedTuple):
    """What ``robe_lookup_bwd.cu``'s launcher derives from the shapes."""
    seg_log2: int     # a pair's run of elements: W = 2^seg_log2 <= Z, 32
    n_seg: int        # pairs an item can span
    band_log2: int    # a pair's band: its first slot >> band_log2
    n_bands: int
    n_buckets: int    # n_bands * F
    sort_blocks: int  # blocks of the bucketing passes
    scratch_bytes: int


def bwd_plan(spec: RobeSpec, n_fields: int, n_items: int,
             dim: int) -> BwdPlan:
    """The backward's plan for ``n_items`` (row, field) items of ``n_fields``
    fields at width ``dim``: an item's elements are cut into pairs, runs of
    at most W = min(Z, 32) elements aligned to W (so each lies in one ROBE
    block); the pairs are bucketed by (band of M, field), with as many
    bands of 2^BAND_LOG2 slots as |M| needs (wider bands when that would
    pass MAX_BUCKETS), by up to SORT_BLOCKS blocks of SORT_THREADS items.
    The scratch holds every block's count (then start) in every bucket, the
    total, each pair's first slot and the sorted pairs (8 bytes each),
    every part 256-byte aligned."""
    lw = min(spec.log2_z, MAX_SEG_LOG2)
    w = 1 << lw
    if dim % w == 0:
        n_seg = dim // w
    elif w % dim == 0:
        n_seg = 1
    else:
        n_seg = ((dim - 1) >> lw) + 2
    band_log2 = BAND_LOG2
    while (((spec.size - 1) >> band_log2) + 1) * n_fields > MAX_BUCKETS:
        band_log2 += 1
    n_bands = ((spec.size - 1) >> band_log2) + 1
    nb = n_bands * n_fields
    blocks = min(SORT_BLOCKS, -(-n_items // SORT_THREADS))
    pairs = n_items * n_seg
    scratch = _build.align(4 * nb * blocks) + 256 + _build.align(4 * pairs) \
        + _build.align(8 * pairs)
    return BwdPlan(lw, n_seg, band_log2, n_bands, nb, blocks, scratch)


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
    plan = bwd_plan(spec, f, b * f, dim)
    if b * f * plan.n_seg >= 2 ** 31 or plan.n_seg > STAGE_PAIRS:
        raise ValueError(f"too many (item, segment) pairs for one launch: "
                         f"{b * f} items of {plan.n_seg}")
    code = _build.dtype_code(g)
    ws = torch.zeros(spec.size, dtype=torch.float32, device=g.device)
    out = ws if g.dtype == torch.float32 else \
        torch.empty(spec.size, dtype=g.dtype, device=g.device)
    if b == 0:
        return out.zero_()
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                          device=g.device)
    coeffs, tid_arr = _build.hash_args(spec, tids)
    err = _build.library().robe_lookup_bwd_launch(
        g.data_ptr(), rows.data_ptr(), ws.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), plan.scratch_bytes, b * f, code, g.stride(0),
        g.stride(1), coeffs, tid_arr, f, dim, spec.log2_z,
        int(spec.use_sign), _build.stream_ptr(g))
    _build.check("robe_lookup_bwd", err)
    robe_lookup_bwd_cuda.launches += 1
    return out


robe_lookup_bwd_cuda.launches = 0
