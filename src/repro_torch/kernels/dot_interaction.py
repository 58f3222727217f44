"""Hopper kernels for the DLRM dot interaction and its backward, beside
their plain versions.

``dot_interaction_cuda`` launches ``csrc/dot_interaction.cu`` (the port
of ``dot_interaction_pallas``): [B, F, D] -> [B, F(F∓1)/2], the lower
gram triangle per sample in ``np.tril_indices`` order, f32-accumulated
and stored in the input dtype. ``dot_interaction_bwd_cuda`` launches
``csrc/dot_interaction_bwd.cu`` (the port of the JAX package's
``_dot_bwd``): the triangle's cotangent and the forward's input ->
dfeats = sym(g) · feats, by a register-tiled contraction with the next
sample's tiles in flight (``bwd_plan`` gives its block layout).
``dot_interaction_ref`` and ``dot_interaction_bwd_ref`` are the plain
versions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (dot_interaction_bwd_ref,
                                     dot_interaction_ref)

__all__ = ["dot_interaction_cuda", "dot_interaction_ref",
           "dot_interaction_bwd_cuda", "dot_interaction_bwd_ref",
           "bwd_plan", "bwd_smem_bytes", "bwd_sym_map"]

#: columns of a window of the backward at most (kMaxWin in
#: csrc/dot_interaction_bwd.cu)
BWD_MAX_WIN = 128
#: threads of a block of the backward at most (kMaxThreads)
BWD_MAX_THREADS = 256
#: units (a sample's window) a block of the backward stages at once at
#: most (kMaxStages)
BWD_MAX_STAGES = 2
#: the sym map's entries: zero, and the flag of the doubled diagonal
#: (kZero, kDiag)
SYM_ZERO, SYM_DIAG = 0xFFFF, 0x8000


class BwdPlan(NamedTuple):
    """The layout of a block of ``csrc/dot_interaction_bwd.cu``."""
    stages: int    # 2: the next unit in flight behind this one's compute
    rwin: int      # output rows of a window (R, a multiple of 4)
    win: int       # columns of a window (W, a multiple of 8)
    threads: int
    smem: int      # bytes of shared memory


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def _pow2_below(n: int, lo: int) -> int:
    p = lo
    while 2 * p < n:
        p *= 2
    return p if p < n else 0


def _plan_with(f, d, self_interaction, itemsize, stages, rwin, win):
    np_ = _round_up(f, 4)
    n_pairs = f * (f + 1) // 2 if self_interaction else f * (f - 1) // 2
    fpitch = win + 8 if itemsize == 2 else win
    gbytes = _round_up((n_pairs + 8) * itemsize, 16)
    fbytes = f * fpitch * itemsize
    cvt = f * win * 4 if itemsize == 2 else 0
    smem = stages * (gbytes + fbytes) + cvt + f * rwin * 4 + \
        _round_up(f * np_ * 2, 16)
    tiles = rwin // 4 * (win // 4)
    threads = _round_up(tiles, 32) if tiles < BWD_MAX_THREADS \
        else BWD_MAX_THREADS
    return BwdPlan(stages, rwin, win, threads, smem)


def bwd_plan(f: int, d: int, self_interaction: bool = False,
             itemsize: int = 4) -> BwdPlan:
    """The backward's block layout at F rows of width D: per stage (a unit
    of work in flight or computing) g's row
    and a window of feats [F, W] in the input dtype (bf16 rows 8 elements
    wider), for bf16 a widened f32 window [F, W], sym's slice [F, R] in f32
    and the 16-bit sym map [F, F rounded up to 4].  The first that fits in
    MAX_SMEM, trying two stages, then one, for each R from all
    rows down, then W from min(D, 128) rounded up to 8 down; ``smem``
    passes MAX_SMEM when none fits."""
    w0 = _round_up(min(d, BWD_MAX_WIN), 8)
    for stages in range(BWD_MAX_STAGES, 0, -1):
        r = _round_up(f, 4)
        while r >= 4:
            w = w0
            while w >= 8:
                p = _plan_with(f, d, self_interaction, itemsize, stages, r, w)
                if p.smem <= _build.MAX_SMEM:
                    return p
                w = _pow2_below(w, 8)
            r = _pow2_below(r, 4)
    return _plan_with(f, d, self_interaction, itemsize, 1, 4, 8)


def bwd_sym_map(f: int, self_interaction: bool = False) -> list:
    """The kernel's sym map, row-major [F][F rounded up to 4]: entry (j, i)
    is the index into g's row of sym[j][i], SYM_ZERO where sym is zero, and
    the index with SYM_DIAG set for the doubled diagonal."""
    np_ = _round_up(f, 4)

    def pairs(i):
        return i * (i + 1) // 2 if self_interaction else i * (i - 1) // 2
    out = []
    for j in range(f):
        for i in range(np_):
            if i >= f or (i == j and not self_interaction):
                out.append(SYM_ZERO)
            elif i == j:
                out.append((i * (i + 1) // 2 + i) | SYM_DIAG)
            else:
                out.append(pairs(i) + j if i > j else pairs(j) + i)
    return out


def dot_interaction_cuda(feats: torch.Tensor,
                         self_interaction: bool = False) -> torch.Tensor:
    """[B, F, D] on the card -> [B, n_pairs] in ``feats``' dtype."""
    if not feats.is_cuda:
        raise ValueError("dot_interaction_cuda needs a CUDA tensor")
    if feats.dim() != 3 or not feats.is_contiguous():
        raise ValueError(f"feats must be a contiguous [B, F, D] tensor, got "
                         f"{tuple(feats.shape)}")
    b, f, d = feats.shape
    if f < 1 or d < 1 or f * (f + 1) // 2 >= 2 ** 31 or b >= 2 ** 31:
        raise ValueError(f"unsupported shape {tuple(feats.shape)}")
    code = _build.dtype_code(feats)
    n_pairs = f * (f + 1) // 2 if self_interaction else f * (f - 1) // 2
    out = torch.empty((b, n_pairs), dtype=feats.dtype, device=feats.device)
    if b == 0 or n_pairs == 0:
        return out
    err = _build.library().dot_interaction_launch(
        feats.data_ptr(), out.data_ptr(), b, f, d, code,
        int(self_interaction), _build.stream_ptr(feats))
    _build.check("dot_interaction", err)
    dot_interaction_cuda.launches += 1
    return out


dot_interaction_cuda.launches = 0


def bwd_smem_bytes(f: int, d: int, self_interaction: bool = False,
                   itemsize: int = 4) -> int:
    """Shared memory of a block of the backward (``bwd_plan``)."""
    return bwd_plan(f, d, self_interaction, itemsize).smem


def dot_interaction_bwd_cuda(g: torch.Tensor, feats: torch.Tensor,
                             self_interaction: bool = False) -> torch.Tensor:
    """The triangle's cotangent g [B, n_pairs] (any row stride, elements
    contiguous) and feats [B, F, D] on the card -> dfeats [B, F, D] in
    ``feats``' dtype."""
    if not (feats.is_cuda and g.device == feats.device):
        raise ValueError("dot_interaction_bwd_cuda needs g and feats on one "
                         "CUDA device")
    if feats.dim() != 3 or not feats.is_contiguous():
        raise ValueError(f"feats must be a contiguous [B, F, D] tensor, got "
                         f"{tuple(feats.shape)}")
    b, f, d = feats.shape
    n_pairs = f * (f + 1) // 2 if self_interaction else f * (f - 1) // 2
    if g.shape != (b, n_pairs) or g.dtype != feats.dtype or \
            (n_pairs > 1 and g.stride(1) != 1):
        raise ValueError(f"g must be [{b}, {n_pairs}] {feats.dtype} with "
                         f"contiguous elements, got {g.dtype} "
                         f"{tuple(g.shape)} strides {g.stride()}")
    if f < 1 or d < 1 or b >= 2 ** 31 or f * d >= 2 ** 31 or \
            n_pairs >= SYM_ZERO & ~SYM_DIAG or \
            bwd_smem_bytes(f, d, self_interaction, feats.element_size()) > \
            _build.MAX_SMEM:
        raise ValueError(f"unsupported shape {tuple(feats.shape)}")
    code = _build.dtype_code(feats)
    if b == 0 or n_pairs == 0:
        return torch.zeros_like(feats)
    out = torch.empty_like(feats)
    err = _build.library().dot_interaction_bwd_launch(
        g.data_ptr(), g.stride(0), feats.data_ptr(), out.data_ptr(), b, f, d,
        code, int(self_interaction), _build.stream_ptr(feats))
    _build.check("dot_interaction_bwd", err)
    dot_interaction_bwd_cuda.launches += 1
    return out


dot_interaction_bwd_cuda.launches = 0
