"""Tensor, sequence and data parallelism of one LM call on a mesh (the
port's explicit stand-in for the layout that GSPMD derives from
``transformer_specs`` in the JAX package).

``Tp.of(ctx, t)`` is the plan of one call with ``t`` tokens a sequence:

* the *model* axes (``rules["mlp"]``; the LM's ``heads``, ``kv_heads``,
  ``vocab``, ``expert``, ``seq`` and ``seq_kv_model`` rules must name the
  same axes), their size M and this rank's index over them;
* the *data* axes: a batch's rows are cut over them (``rows``) when its
  size divides them, else every data rank holds every row;
* ``sp``: whether the activations between blocks are cut along the
  sequence over the model axes (Megatron sequence parallelism: T divides
  M).  A block takes the whole sequence (``seq_in``: an all-gather) and
  hands its output back in the layout (``seq_out``: a reduce-scatter of a
  row-parallel partial sum, an all-reduce without ``sp``).

``view(w, stored, want)`` turns a parameter as the rank holds it (its
shard by the live spec ``stored``; None: whole) into the block the
computation wants (``want``): dims sharded otherwise are all-gathered
(differentiable, the transpose a reduce-scatter: the ``fsdp`` leaves and
a column cut the computation cannot use), then the rank's block of the
wanted dims is cut out.  Every collective is ``dist.collectives``', so
gradients follow ``dist.api``'s rule: no identity/all-reduce pair is
added on top.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.dist import collectives as coll
from repro_torch.dist.api import DistContext, P, axes_on_mesh, axes_tuple

#: the logical axes the LM lays out over the model axes
MODEL_RULES = ("mlp", "heads", "kv_heads", "vocab", "expert", "seq",
               "seq_kv_model")


@dataclasses.dataclass(frozen=True)
class Tp:
    ctx: DistContext
    axes: Tuple[str, ...]        # the model axes
    size: int                    # M
    index: int                   # this rank over ``axes``
    dp: Tuple[str, ...]          # the data axes
    sp: bool                     # activations cut along the sequence

    @classmethod
    def of(cls, ctx: DistContext, t: int) -> "Tp":
        def on(name):
            return axes_on_mesh(axes_tuple(ctx.rules.get(name)), ctx.mesh)
        axes = on("mlp")
        if not axes or any(on(r) != axes for r in MODEL_RULES):
            raise NotImplementedError(
                f"the LM on a mesh lays heads, mlp, vocab, experts and the "
                f"sequence over one set of model axes; the rules give "
                f"{ {r: on(r) for r in MODEL_RULES} }")
        size = ctx.size(axes)
        return cls(ctx, axes, size, ctx.index(axes), ctx.dp_axes,
                   t % size == 0)

    def splits(self, n: int) -> bool:
        """Whether a dim of ``n`` cuts over the model axes."""
        return n % self.size == 0

    # -- blocks over the model axes ----------------------------------------

    def block(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``x`` along ``dim`` over the model axes."""
        m = x.shape[dim] // self.size
        return x.narrow(dim, self.index * m, m)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The model ranks' blocks joined along ``dim`` (differentiable)."""
        return coll.all_gather(x, self.ctx, self.axes, dim=dim)

    def seq_in(self, x: torch.Tensor) -> torch.Tensor:
        """A block's input [b, T, ...]: the whole sequence."""
        return self.gather(x, 1) if self.sp else x

    def seq_out(self, h: torch.Tensor, partial: bool) -> torch.Tensor:
        """A block's output [b, T, ...] back in the layout between blocks:
        a row-parallel ``partial`` sum reduced over the model axes (and
        scattered along the sequence with ``sp``); a whole output cut to
        the rank's sequence block with ``sp``."""
        if partial:
            if self.sp:
                return coll.reduce_scatter(h, self.ctx, self.axes, dim=1)
            return coll.all_reduce(h, self.ctx, self.axes)
        return self.block(h, 1) if self.sp else h

    # -- rows over the data axes -------------------------------------------

    def row_split(self, n: int) -> bool:
        return bool(self.dp) and n % self.ctx.size(self.dp) == 0

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows (dim 0) of a global batch."""
        if not self.row_split(x.shape[0]):
            return x
        m = x.shape[0] // self.ctx.size(self.dp)
        return x.narrow(0, self.ctx.index(self.dp) * m, m)

    def n_rows(self, n: int) -> int:
        return n // self.ctx.size(self.dp) if self.row_split(n) else n

    def gather_rows(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """The inverse of ``rows`` for a global batch of ``n`` rows."""
        if not self.row_split(n):
            return x
        return coll.all_gather(x, self.ctx, self.dp, dim=0)

    def mean(self, local: torch.Tensor, n: int) -> torch.Tensor:
        """The mean over the data ranks of each one's mean ``local`` of
        its rows of a batch of ``n`` rows as the value; the gradient that
        of ``local`` (``dist.api`` contract point 4)."""
        if not self.row_split(n):
            return local
        total = coll.all_reduce_(local.detach().clone(), self.ctx, self.dp)
        return local + (total / self.ctx.size(self.dp) - local).detach()

    # -- parameters ----------------------------------------------------------

    def view(self, w: torch.Tensor, stored: Optional[P],
             want: Optional[P]) -> torch.Tensor:
        """The block of ``w`` that ``want`` names, from the shard
        ``stored`` names (None: whole)."""
        for i in range(w.dim()):
            s = axes_tuple(stored[i]) if stored is not None and \
                i < len(stored) else ()
            t = axes_tuple(want[i]) if want is not None and \
                i < len(want) else ()
            if s == t:
                continue
            if s:
                w = coll.all_gather(w, self.ctx, s, dim=i)
            if t:
                n = self.ctx.size(t)
                m = w.shape[i] // n
                w = w.narrow(i, self.ctx.index(t) * m, m)
        return w
