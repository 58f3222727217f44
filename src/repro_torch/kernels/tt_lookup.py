"""Hopper kernel for the tensor-train lookup, beside its plain version.

``tt_lookup_cuda`` launches ``csrc/tt_lookup.cu`` (the port of
``tt_lookup_pallas``): [B, F] int32 ids -> [B, F, d1·d2·d3] embeddings, the
chain G1[i1]·G2[i2]·G3[i3] over the mixed-radix split of ``id + off[f]``,
accumulated in f32 and rounded once to the cores' dtype.
``tt_lookup_ref`` is the plain PyTorch version it is held against.

``tt_lookup_bwd_cuda`` launches ``csrc/tt_lookup_bwd.cu`` (the port of the
JAX package's ``_tt_bwd``): the cotangent -> the three cores' gradients by
the chain rule through ``(c1·c2)·c3``.  At ranks 4 and 8 (d1 <= 2, d2 <= 8,
r·d3 <= 64) the items are sorted once, by core1's and core2's rows
(``csrc/row_sort.cuh``), and walked once, a run's core1 slice and gradient
in registers, core0's and core2's gradients summed in registers while their
row repeats; other shapes sort and walk once for each core.  ``bwd_plan``
mirrors the choice; every (dims, rank) the forward takes is taken.
``tt_lookup_bwd_ref`` is its plain version.

The forward kernel has one instance per rank in ``RANKS`` (the chain's rows held
in registers) and a path for any other rank; ``plan`` picks one from the
shapes alone, and the launcher refuses an instance that does not match.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import MAX_SMEM
from repro_torch.kernels.ref import tt_lookup_bwd_ref, tt_lookup_ref

__all__ = ["tt_lookup_cuda", "tt_lookup_ref", "tt_lookup_bwd_cuda",
           "tt_lookup_bwd_ref", "plan", "bwd_plan", "bwd_split",
           "TtBwdPlan"]

#: warps of a block of the ranked instances: kWarps in csrc/tt_lookup.cu
WARPS = 2
#: warps of a block of the any-rank path: kAnyWarps in csrc/tt_lookup.cu
ANY_WARPS = 8
#: ranks with an instance of their own: kRanks in csrc/tt_lookup.cu, and
#: kTbRanks in csrc/tt_lookup_bwd.cu
RANKS = (4, 8)
#: the backward's ranked walk: warps of a block (kTbWarps) and lanes of an
#: item (kTbLanes) in csrc/tt_lookup_bwd.cu
BWD_WARPS, BWD_LANES = 8, 8
#: warps of a block of the backward's first-design walks: kWalkWarps
BWD_WALK_WARPS = 8
#: the ranked walk's largest core2 row (r·d3, kTbMaxRow3) and sort keys
#: (n2·n3, kTbMaxKeys); the core0 rows a group keeps (kTbSlots) and the
#: largest block copy of core0's gradient, in floats (kTbMaxCopy)
BWD_MAX_ROW3, BWD_MAX_KEYS = 64, 1 << 24
BWD_SLOTS, BWD_MAX_COPY = 8, 16384


def _pad16(n: int) -> int:
    return (n + 15) & ~15


def plan(d1: int, d2: int, d3: int, rank: int, itemsize: int,
         aligned: bool = True) -> tuple:
    """(instance, shared memory bytes of a block) for cores of these shapes
    and element size: the rank itself when it has an instance, the cores
    are 16-byte aligned and a block fits; else 0, the any-rank path.
    Mirrors ``launch_ranked`` and ``launch`` in csrc/tt_lookup.cu."""
    if rank in RANKS and aligned:
        pairs = d2 * ((d1 + 1) // 2)    # a lane's rows: (a, b), (a+1, b)
        items = 32 // min(pairs, 32)    # items a warp takes at once
        slot = (_pad16(d1 * rank * itemsize)
                + _pad16(rank * d2 * rank * itemsize)
                + _pad16(rank * d3 * itemsize))     # one item's slices
        smem = WARPS * 2 * items * slot             # two buffers of slots
        if smem <= MAX_SMEM:
            return rank, smem
    return 0, 4 * ANY_WARPS * (d1 * rank + rank * d2 * rank + rank * d3
                               + d1 * d2 * rank)


class TtBwdPlan(NamedTuple):
    """How csrc/tt_lookup_bwd.cu takes a backward of these shapes."""
    instance: int   # the ranked walk's rank, or 0: three sorts and walks
    smem: int       # shared memory bytes of a block of the walk taken
    keys: int       # keys of the walk's largest sort
    staged: bool    # the first design: g's row staged in shared memory
    warps: int      # the first design's warps a block; 0: does not fit


def bwd_plan(d1: int, d2: int, d3: int, rank: int, n1: int = 1,
             n2: int = 1, n3: int = 1) -> TtBwdPlan:
    """Mirrors ``tb_instance`` and the launcher of csrc/tt_lookup_bwd.cu.
    The ranked walk takes a rank in ``RANKS`` with d1 <= 2, d2 <=
    ``BWD_LANES``, r·d3 a multiple of 8 up to ``BWD_MAX_ROW3`` (a lane's
    share of a core2 row's gradient sits in registers) and n2·n3 up to
    ``BWD_MAX_KEYS``: its one sort is by (i2, i3), n2·n3 keys; its shared
    memory holds ``BWD_SLOTS`` core0 rows a group and, where core0's
    gradient has at most ``BWD_MAX_COPY`` floats, a block copy of it.  The
    first
    design's walks hold, a warp, the three slices, t and the largest row of
    the three gradients as f32 (at most twice an item of the forward's
    any-rank path, so every shape the forward takes fits), and g's row too
    when a block of ``BWD_WALK_WARPS`` warps still fits; otherwise g is
    read through L1.  The launcher refuses a shape whose first-design warp
    does not fit (warps 0), whichever walk it takes."""
    row = max(d1 * rank, rank * d2 * rank, rank * d3)
    rest = 4 * (d1 * rank + rank * d2 * rank + rank * d3 + d1 * d2 * rank
                + row)
    staged = BWD_WALK_WARPS * (rest + 4 * d1 * d2 * d3) <= MAX_SMEM
    per_warp = rest + (4 * d1 * d2 * d3 if staged else 0)
    warps = min(BWD_WALK_WARPS, MAX_SMEM // per_warp)
    row3 = rank * d3
    if rank in RANKS and d1 <= 2 and d2 <= BWD_LANES and \
            row3 <= BWD_MAX_ROW3 and row3 % 8 == 0 and \
            n2 * n3 <= BWD_MAX_KEYS:
        copy = n1 * d1 * rank if n1 * d1 * rank <= BWD_MAX_COPY else 0
        smem = 4 * (BWD_WARPS * 32 // BWD_LANES * BWD_SLOTS * 2 * rank + copy)
        return TtBwdPlan(rank, smem, max(n1, n2, n3, n2 * n3), staged, warps)
    return TtBwdPlan(0, warps * per_warp, max(n1, n2, n3), staged, warps)


def bwd_split(n_items: int, resident: int) -> tuple:
    """(blocks, groups, most places of a group) of the ranked walk over
    ``n_items`` sorted places when the card holds ``resident`` of its
    blocks at once (one an SM at full width): no more blocks than give each
    group of ``BWD_LANES`` lanes a place, and group k takes the places
    [k·n // groups, (k+1)·n // groups).  Mirrors ``launch_ranked`` and
    ``tt_ranked_bwd_kernel`` in csrc/tt_lookup_bwd.cu."""
    per_block = BWD_WARPS * 32 // BWD_LANES
    blocks = min(resident, -(-n_items // per_block))
    groups = blocks * per_block
    return blocks, groups, -(-n_items // groups)


def tt_lookup_cuda(core0: torch.Tensor, core1: torch.Tensor,
                   core2: torch.Tensor, idx: torch.Tensor, offsets,
                   factors, dim: int) -> torch.Tensor:
    """core0 [n1, d1, r], core1 [n2, r, d2, r], core2 [n3, r, d3] of one
    dtype and [B, F] int32 ids in [0, vocab), all on one CUDA device ->
    [B, F, dim] (dim = d1·d2·d3) in the cores' dtype."""
    dev = core0.device
    if not (core0.is_cuda and core1.device == dev and core2.device == dev
            and idx.device == dev):
        raise ValueError("tt_lookup_cuda needs the cores and idx on one CUDA "
                         "device")
    if not (core1.dtype == core0.dtype == core2.dtype):
        raise ValueError("the three cores must share a dtype")
    if core0.dim() != 3 or core1.dim() != 4 or core2.dim() != 3:
        raise ValueError("cores must be [n1, d1, r], [n2, r, d2, r] and "
                         "[n3, r, d3]")
    n1, d1, r = core0.shape
    n2, d2, n3, d3 = core1.shape[0], core1.shape[2], core2.shape[0], \
        core2.shape[2]
    if core1.shape != (n2, r, d2, r) or core2.shape != (n3, r, d3):
        raise ValueError(f"core shapes disagree on the rank: "
                         f"{tuple(core0.shape)}, {tuple(core1.shape)}, "
                         f"{tuple(core2.shape)}")
    if tuple(int(n) for n in factors) != (n1, n2, n3):
        raise ValueError(f"factors {tuple(factors)} are not the cores' rows "
                         f"{(n1, n2, n3)}")
    if dim != d1 * d2 * d3:
        raise ValueError(f"dim {dim} != d1*d2*d3 = {d1 * d2 * d3}")
    if idx.dtype != torch.int32 or idx.dim() != 2:
        raise ValueError(f"idx must be [B, F] int32, got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if not all(t.is_contiguous() for t in (core0, core1, core2, idx)):
        raise ValueError("tt_lookup_cuda takes contiguous tensors")
    b, f = idx.shape
    off = tuple(int(o) for o in offsets)
    if len(off) != f:
        raise ValueError(f"{len(off)} offsets for {f} fields")
    # a valid id gives a global row g = id + off[f] below n1·n2·n3, so the
    # kernel's int32 g cannot overflow when the cores' product fits
    if n1 * n2 * n3 >= 2 ** 31 or max(off) >= n1 * n2 * n3:
        raise ValueError(f"global rows must stay below 2^31: factors "
                         f"{(n1, n2, n3)}, largest offset {max(off)}")
    code = _build.dtype_code(core0)
    aligned = all(c.data_ptr() % 16 == 0 for c in (core0, core1, core2))
    instance, smem = plan(d1, d2, d3, r, core0.element_size(), aligned)
    if smem > MAX_SMEM:
        raise ValueError(f"cores too wide: a block needs {smem} bytes of "
                         f"shared memory, more than {MAX_SMEM}")
    if b * f >= 2 ** 31:
        raise ValueError(f"batch too large for one launch: B*F = {b * f}")
    out = torch.empty((b, f, dim), dtype=core0.dtype, device=dev)
    if b == 0:
        return out
    err = _build.library().tt_lookup_launch(
        core0.data_ptr(), core1.data_ptr(), core2.data_ptr(), idx.data_ptr(),
        out.data_ptr(), b * f, code, _build.field_args(off), f, n2, n3, d1,
        d2, d3, r, instance, _build.stream_ptr(core0))
    _build.check("tt_lookup", err)
    tt_lookup_cuda.launches += 1
    return out


tt_lookup_cuda.launches = 0


def tt_lookup_bwd_cuda(g: torch.Tensor, core0: torch.Tensor,
                       core1: torch.Tensor, core2: torch.Tensor,
                       idx: torch.Tensor, offsets, factors) -> tuple:
    """The lookup's cotangent g [B, F, d1·d2·d3] in the cores' dtype (any
    batch and field strides, elements contiguous), the three cores (any
    alignment) and the [B, F] int32 ids in [0, vocab), on one CUDA device
    -> the cores' gradients in their dtype, each row summed in f32 in no
    fixed order."""
    dev = core0.device
    if not (g.is_cuda and core0.device == g.device and core1.device == dev
            and core2.device == dev and idx.device == dev):
        raise ValueError("tt_lookup_bwd_cuda needs g, the cores and idx on "
                         "one CUDA device")
    if not (core1.dtype == core0.dtype == core2.dtype == g.dtype):
        raise ValueError("g and the three cores must share a dtype")
    if core0.dim() != 3 or core1.dim() != 4 or core2.dim() != 3 or \
            not all(c.is_contiguous() for c in (core0, core1, core2)):
        raise ValueError("cores must be contiguous [n1, d1, r], "
                         "[n2, r, d2, r] and [n3, r, d3]")
    n1, d1, r = core0.shape
    n2, d2, n3, d3 = core1.shape[0], core1.shape[2], core2.shape[0], \
        core2.shape[2]
    if core1.shape != (n2, r, d2, r) or core2.shape != (n3, r, d3):
        raise ValueError(f"core shapes disagree on the rank: "
                         f"{tuple(core0.shape)}, {tuple(core1.shape)}, "
                         f"{tuple(core2.shape)}")
    if tuple(int(n) for n in factors) != (n1, n2, n3):
        raise ValueError(f"factors {tuple(factors)} are not the cores' rows "
                         f"{(n1, n2, n3)}")
    if idx.dtype != torch.int32 or idx.dim() != 2 or \
            not idx.is_contiguous():
        raise ValueError(f"idx must be contiguous [B, F] int32, got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    b, f = idx.shape
    dim = d1 * d2 * d3
    if g.shape != (b, f, dim) or g.stride(2) != 1:
        raise ValueError(f"g must be [{b}, {f}, {dim}] with contiguous "
                         f"elements, got {tuple(g.shape)} strides "
                         f"{g.stride()}")
    off = tuple(int(o) for o in offsets)
    if len(off) != f:
        raise ValueError(f"{len(off)} offsets for {f} fields")
    if n1 * n2 * n3 >= 2 ** 31 or max(off) >= n1 * n2 * n3 or \
            b * f >= 2 ** 31:
        raise ValueError(f"global rows and B*F must stay below 2^31: "
                         f"factors {(n1, n2, n3)}, B*F = {b * f}")
    bp = bwd_plan(d1, d2, d3, r, n1, n2, n3)
    if bp.warps < 1:
        raise ValueError(f"cores too wide for the backward's shared memory: "
                         f"dims {(d1, d2, d3)}, rank {r}")
    code = _build.dtype_code(g)
    cores = (core0, core1, core2)
    ws = [torch.zeros(c.shape, dtype=torch.float32, device=dev)
          for c in cores]
    outs = ws if g.dtype == torch.float32 else \
        [torch.zeros(c.shape, dtype=g.dtype, device=dev) for c in cores]
    if b == 0:
        return tuple(outs)
    nbytes = _build.row_sort_bytes(bp.keys, b * f)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    err = _build.library().tt_lookup_bwd_launch(
        g.data_ptr(), core0.data_ptr(), core1.data_ptr(), core2.data_ptr(),
        idx.data_ptr(), *(w.data_ptr() for w in ws),
        *(o.data_ptr() for o in outs), scratch.data_ptr(), nbytes, b * f,
        code, g.stride(0), g.stride(1), _build.field_args(off), f, n1, n2,
        n3, d1, d2, d3, r, _build.stream_ptr(g))
    _build.check("tt_lookup_bwd", err)
    tt_lookup_bwd_cuda.launches += 1
    return tuple(outs)


tt_lookup_bwd_cuda.launches = 0
