"""Collectives over a ``DistContext``'s mesh axes, with their transposes
(the port's stand-in for ``jax.lax``'s collectives; the JAX package has no
module of its own for them).

* ``all_gather(x, ctx, axes, dim)``: the blocks of the ranks along
  ``axes`` joined along ``dim`` (tiled), in the linear order of ``axes``;
  its backward is ``reduce_scatter`` of the cotangent, as JAX transposes
  a tiled ``all_gather`` into a ``psum_scatter``.
* ``reduce_scatter(x, ctx, axes, dim)``: the sum over the ranks along
  ``axes``, each keeping its block of ``dim``; its backward is
  ``all_gather``.
* ``all_to_all(x, ctx, axes, split_dim, concat_dim)``: ``x`` cut into
  one block a rank along ``split_dim``, block i sent to the i-th rank
  along ``axes``, and the blocks received joined along ``concat_dim`` in
  the ranks' order (``jax.lax.all_to_all(..., tiled=True)``); its
  backward is the same exchange of the cotangent with the two dims
  swapped (the same call when they are equal).
* ``all_reduce(x, ctx, axes)``: the sum over the ranks along ``axes``;
  its backward is ``all_reduce`` of the cotangents.  Every rank
  back-propagates its own share of the loss (``dist.api`` contract point
  4), so the cotangents that the ranks hold for the replicated result add
  up; the one-controller equivalent is JAX's identity transpose of a
  ``psum`` whose cotangent is already the whole one.
* no gradient: ``all_reduce_`` (in place, any op), ``agree_all`` /
  ``agree_any`` (a flag every rank shares: MIN / MAX) and
  ``agree_failure`` (an exception on one rank becomes one on every rank,
  so that all take the same branch).

``counts`` adds one per call of each collective, so tests and the chip
smoke can show a path really exchanged (the ZeRO-3 gather), and
``nbytes`` the bytes of each call's output (the quantity the JAX dry run
sums from a compiled module's HLO; ``launch.dryrun`` reads both).  Each call is
a real collective even on a group of one rank (a copy), so a one-rank
NCCL mesh runs every sharded code path.
"""

from __future__ import annotations

import collections
import warnings

import torch
import torch.distributed as tdist

# newer torch renames all_gather_into_tensor and reduce_scatter_tensor
# (the same calls) and warns on every use; the names stay, since older
# torch has only them
warnings.filterwarnings(
    "ignore", message=".*(all_gather_into_tensor|reduce_scatter_tensor)",
    category=FutureWarning)

#: calls of each collective since the last ``counts.clear()``
counts: collections.Counter = collections.Counter()
#: output bytes of each collective's calls since the last ``nbytes.clear()``
nbytes: collections.Counter = collections.Counter()


def _log(op: str, out: torch.Tensor) -> torch.Tensor:
    counts[op] += 1
    nbytes[op] += out.numel() * out.element_size()
    return out


def _front(x: torch.Tensor, dim: int) -> torch.Tensor:
    return (x if dim == 0 else x.movedim(dim, 0)).contiguous()


def _gather(x, ctx, axes, dim):
    n = ctx.size(axes)
    x = _front(x, dim)
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    tdist.all_gather_into_tensor(out, x, group=ctx.group(axes))
    _log("all_gather", out)
    return out if dim == 0 else out.movedim(0, dim)


def _scatter(x, ctx, axes, dim):
    n = ctx.size(axes)
    x = _front(x, dim)
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of size {x.shape[0]} "
                         f"does not divide {axes} of size {n}")
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    tdist.reduce_scatter_tensor(out, x, op=tdist.ReduceOp.SUM,
                                group=ctx.group(axes))
    _log("reduce_scatter", out)
    return out if dim == 0 else out.movedim(0, dim)


def _exchange(x, ctx, axes, split_dim, concat_dim):
    n = ctx.size(axes)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of size "
                         f"{x.shape[split_dim]} does not divide {axes} of "
                         f"size {n}")
    xs = _front(x, split_dim)
    out = torch.empty_like(xs)
    tdist.all_to_all_single(out, xs, group=ctx.group(axes))
    _log("all_to_all", out)
    # out[j] is rank j's block for this rank: [n, S/n, ...rest] with the
    # split dim back in its place, then the n blocks joined along concat
    blocks = out.reshape((n, xs.shape[0] // n) + tuple(xs.shape[1:]))
    if split_dim:
        blocks = blocks.movedim(1, split_dim + 1)
    shape = list(blocks.shape[1:])
    shape[concat_dim] *= n
    return blocks.movedim(0, concat_dim).reshape(shape)


def _reduce(x, ctx, axes, op=tdist.ReduceOp.SUM):
    out = x.contiguous().clone()
    tdist.all_reduce(out, op=op, group=ctx.group(axes))
    return _log("all_reduce", out)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes, dim):
        fctx.args = (ctx, axes, dim)
        return _gather(x, ctx, axes, dim)

    @staticmethod
    def backward(fctx, g):
        return (_scatter(g, *fctx.args),) + (None,) * 3


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes, dim):
        fctx.args = (ctx, axes, dim)
        return _scatter(x, ctx, axes, dim)

    @staticmethod
    def backward(fctx, g):
        return (_gather(g, *fctx.args),) + (None,) * 3


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes, split_dim, concat_dim):
        fctx.args = (ctx, axes, concat_dim, split_dim)
        return _exchange(x, ctx, axes, split_dim, concat_dim)

    @staticmethod
    def backward(fctx, g):
        return (_exchange(g, *fctx.args),) + (None,) * 4


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes):
        fctx.args = (ctx, axes)
        return _reduce(x, ctx, axes)

    @staticmethod
    def backward(fctx, g):
        return (_reduce(g, *fctx.args),) + (None,) * 2


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def all_gather(x: torch.Tensor, ctx, axes, dim: int = 0) -> torch.Tensor:
    return _AllGather.apply(x, ctx, _axes(axes), dim)


def reduce_scatter(x: torch.Tensor, ctx, axes, dim: int = 0) -> torch.Tensor:
    return _ReduceScatter.apply(x, ctx, _axes(axes), dim)


def all_to_all(x: torch.Tensor, ctx, axes, split_dim: int = 0,
               concat_dim: int = 0) -> torch.Tensor:
    return _AllToAll.apply(x, ctx, _axes(axes), split_dim, concat_dim)


def all_reduce(x: torch.Tensor, ctx, axes) -> torch.Tensor:
    return _AllReduce.apply(x, ctx, _axes(axes))


def all_reduce_(x: torch.Tensor, ctx, axes, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce without a gradient; ``op`` is sum, max or min."""
    tdist.all_reduce(x, op=getattr(tdist.ReduceOp, op.upper()),
                     group=ctx.group(_axes(axes)))
    return _log("all_reduce", x)


def _agree(flag, ctx, op: str) -> torch.Tensor:
    t = torch.as_tensor(flag).to(device=ctx.device, dtype=torch.int32)
    return all_reduce_(t.reshape(1).clone(), ctx, ctx.mesh.axis_names,
                       op)[0].bool()


def agree_all(flag, ctx) -> torch.Tensor:
    """True on every rank iff ``flag`` is true on every rank of the mesh
    (an all-reduce MIN; a 0-d bool tensor on the mesh's device)."""
    return _agree(flag, ctx, "min")


def agree_any(flag, ctx) -> torch.Tensor:
    """True on every rank iff ``flag`` is true on some rank of the mesh
    (an all-reduce MAX)."""
    return _agree(flag, ctx, "max")


def agree_failure(err, ctx, key: int = 0):
    """The failure every rank of the mesh acts on at one point: ``err``
    where this rank failed, a ``RuntimeError`` where only another rank
    did, else None (an all-reduce MAX of the flag; every rank waits for
    the others, as at a barrier).  ``key`` names the point (a step, say):
    ranks that reach the all-reduce from different points raise rather
    than act on each other's flags."""
    t = torch.tensor([int(err is not None), key, -key], dtype=torch.int64,
                     device=ctx.device)
    failed, hi, lo = all_reduce_(t, ctx, ctx.mesh.axis_names, "max").tolist()
    if hi != -lo:
        raise RuntimeError(f"ranks out of step: they met at points "
                           f"{-lo} .. {hi}")
    if failed and err is None:
        return RuntimeError(f"another rank of the mesh failed at point {key}")
    return err
