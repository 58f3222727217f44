"""Hopper kernel for the tensor-train lookup, beside its plain version.

``tt_lookup_cuda`` launches ``csrc/tt_lookup.cu`` (the port of
``tt_lookup_pallas``): [B, F] int32 ids -> [B, F, d1·d2·d3] embeddings, the
chain G1[i1]·G2[i2]·G3[i3] over the mixed-radix split of ``id + off[f]``,
accumulated in f32 and rounded once to the cores' dtype.
``tt_lookup_ref`` is the plain PyTorch version it is held against.

The kernel has one instance per rank in ``RANKS`` (the chain's rows held
in registers) and a path for any other rank; ``plan`` picks one from the
shapes alone, and the launcher refuses an instance that does not match.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import MAX_SMEM
from repro_torch.kernels.ref import tt_lookup_ref

__all__ = ["tt_lookup_cuda", "tt_lookup_ref", "plan"]

#: warps of a block of the ranked instances: kWarps in csrc/tt_lookup.cu
WARPS = 2
#: warps of a block of the any-rank path: kAnyWarps in csrc/tt_lookup.cu
ANY_WARPS = 8
#: ranks with an instance of their own: kRanks in csrc/tt_lookup.cu
RANKS = (4, 8)


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
