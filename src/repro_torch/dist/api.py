"""Mesh context + logical-axis layouts (PyTorch port of ``repro.dist.api``).

The models never name mesh axes directly: tensors are described by
*logical* axes ("batch", "flat_batch", "table_rows", "candidates", ...)
and the active ``DistContext`` maps those to physical mesh axes through
its ``rules`` table (``default_rules``, the JAX package's).  Outside a
context every helper is a no-op, so the same model code runs unchanged on
one device and on a mesh of ``torch.distributed`` ranks.

Design contract of the port's distribution (one process per rank, where
the JAX package is one controller over every device):

1. **Global in, global out; shards inside.**  Every rank receives the same
   global batch (``batch_at`` is pure in (seed, step)).  Each entry point
   (``models.recsys.forward`` / ``loss_fn`` / ``serve_scores``,
   ``EmbeddingServer.score``) cuts out the rank's rows where the JAX
   package's layouts put them: the dense rows and the MLPs by
   ``flat_batch`` (``batch_rows``: data-major, then model; every row on
   every rank when the batch does not divide the mesh), the sparse ids by
   what the backend's ``lookup_dist`` takes (``P(dp, None)`` for the
   row-sharded ``full`` table, ``P(every, None)`` for ZeRO-3 ``robe``).
   It returns global results: the mean loss by an ``all_reduce``, logits
   and scores by an ``all_gather``.  Parameters are held as the rank's
   local shard of each leaf, by its spec tree (``place`` cuts a global
   tree into shards, ``gather`` is its inverse).  The caller that placed
   them passes that tree on to the lookups (``placed``: the train step,
   the server); without it a backend takes its own layout,
   ``param_specs`` on the current mesh.
2. **Specs.**  ``P`` is a tuple of per-dimension entries (``None``, an
   axis name or a tuple of names).  ``resolve_spec``, ``prune_specs``,
   ``axes_*`` and every backend's ``param_specs`` return the entries the
   JAX functions return; like them they read only ``mesh.axis_names`` and
   ``mesh.shape``.
3. **Collectives carry their transposes** (``dist.collectives``, which
   stands for ``jax.lax``'s collectives): ``all_gather`` <->
   ``reduce_scatter``; a differentiable ``all_reduce`` (sum) transposes
   into an ``all_reduce`` of the cotangents, because every rank
   back-propagates its own share of the loss (below), so the cotangents
   of a replicated result from the ranks add up.
4. **Gradient rule.**  Rank r back-propagates its local mean loss L_r;
   the global mean loss is L = (1/n) sum_r L_r over the n ranks (also
   when the batch does not divide and every rank holds every row).  After
   the backward, each leaf's gradient is summed over the mesh axes the
   leaf is *replicated* over (data and model for the dense towers; data
   for a ``model``-sharded table or ZeRO-3 array; none for ``2d``) and
   scaled once by 1/n: it is then JAX's single-device gradient of L,
   restricted to the rank's shard.  ``train.train_loop``'s step applies
   this, from the live spec tree, in one place.
5. **Decisions every rank must share are agreed by a collective**: the
   NaN guard's ``finite`` (an all-reduce MIN of the flag) and the
   straggler monitor's re-slice trigger (an all-reduce MAX).  Otherwise
   replicas diverge, or a rank deadlocks in the next collective.
6. **Device.**  ``launch.mesh.make_mesh(shape, axes, device=None)`` builds
   on ``cuda`` with NCCL unless the caller passes ``device="cpu"`` (gloo),
   as the tests do.  There is no fallback from one to the other: a
   ``cuda`` mesh without a card raises.

Layout conventions encoded in ``default_rules`` (the JAX package's):
``batch`` over the data axes, ``flat_batch`` over the whole mesh,
``table_rows`` and ``candidates`` over ``model``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.tree import leaves, leaves_up_to, tree_map, unflatten

AxisRule = Union[None, str, Tuple[str, ...]]


def _entry_norm(e):
    if e is None or isinstance(e, str):
        return e
    e = tuple(e)
    return e[0] if len(e) == 1 else e


class P:
    """A partition spec: one entry per leading dimension of a tensor --
    ``None`` (replicated), a mesh-axis name, or a tuple of names (the
    dimension split over their product, the first name outermost).
    Missing trailing entries are replicated.  A one-name tuple is stored
    as the name, as ``jax.sharding.PartitionSpec`` stores it."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        self._entries = tuple(_entry_norm(e) for e in entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self._entries == other._entries

    def __hash__(self) -> int:
        return hash(("P",) + self._entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self._entries)) + ")"


def axes_tuple(rule: AxisRule) -> tuple:
    """Normalize a rules-table / spec entry (None | str | tuple) to a tuple
    of mesh-axis names."""
    if rule is None:
        return ()
    return (rule,) if isinstance(rule, str) else tuple(rule)


def axes_entry(axes: tuple):
    """One spec entry from a mesh-axes tuple."""
    return axes[0] if len(axes) == 1 else axes


def axes_on_mesh(axes: tuple, mesh) -> tuple:
    """Keep only the axes a concrete mesh still carries (``mesh=None``: all
    of them) -- layouts re-resolve through this on a degraded mesh."""
    if mesh is None:
        return axes
    return tuple(a for a in axes if a in mesh.axis_names)


def default_rules(multi_pod: bool = False) -> Dict[str, AxisRule]:
    """Logical-axis -> mesh-axis table for the production meshes."""
    dp: AxisRule = ("pod", "data") if multi_pod else "data"
    every = ("pod", "data", "model") if multi_pod else ("data", "model")
    return {
        "batch": dp,
        "flat_batch": every,
        "seq": "model",
        "embed": None,
        "mlp": "model",
        "heads": "model",
        "kv_heads": "model",
        "vocab": "model",
        "expert": "model",
        "candidates": "model",
        "seq_kv_model": "model",
        "table_rows": "model",
    }


@dataclasses.dataclass(frozen=True)
class DistContext:
    """A mesh and its rules.  ``mesh`` is a ``launch.mesh.Mesh`` (or, for
    the pure spec functions, any object with ``axis_names`` and
    ``shape``); the rank's coordinates and process groups come from it."""

    mesh: Any
    rules: Dict[str, AxisRule]
    multi_pod: bool = False

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        """The data-parallel mesh axes: ("data",) or ("pod", "data")."""
        return tuple(a for a in ("pod", "data") if a in self.mesh.axis_names)

    @property
    def dp_size(self) -> int:
        return self.size(self.dp_axes)

    @property
    def n_devices(self) -> int:
        return self.size(tuple(self.mesh.axis_names))

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """The mesh axes of ``flat_batch``: the axes a batch's rows split
        over (data-major, then model)."""
        return axes_on_mesh(axes_tuple(self.rules.get("flat_batch")),
                            self.mesh)

    @property
    def is_member(self) -> bool:
        """Whether this rank is one of the mesh's devices (a rank dropped
        by ``launch.mesh.degrade_mesh`` is not)."""
        return self.mesh.coords is not None

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def size(self, axes: Sequence[str]) -> int:
        n = 1
        for a in axes:
            n *= self.mesh.shape[a]
        return n

    def index(self, axes: Sequence[str]) -> int:
        """This rank's linear index over ``axes`` (row-major in the given
        order, as ``jax.lax.axis_index`` of a tuple of axes)."""
        i = 0
        for a in axes:
            i = i * self.mesh.shape[a] + int(self.mesh.coords[a])
        return i

    def group(self, axes: Sequence[str]):
        """The process group of the ranks that share this rank's
        coordinates on every axis but ``axes``."""
        return self.mesh.group(tuple(axes))


class _Stack(threading.local):
    def __init__(self):
        self.ctxs = []
        self.specs = []


_STACK = _Stack()


def current() -> Optional[DistContext]:
    """The innermost active context, or None (single-device semantics)."""
    return _STACK.ctxs[-1] if _STACK.ctxs else None


@contextlib.contextmanager
def use(ctx: DistContext):
    """Activate ``ctx`` for the current thread."""
    _STACK.ctxs.append(ctx)
    try:
        yield ctx
    finally:
        _STACK.ctxs.pop()


@contextlib.contextmanager
def placed(specs):
    """Make ``specs``, the live ``P`` tree of the parameters in use, the
    layout that the backends' ``lookup_dist`` reads for the duration.  A
    shard does not carry its layout; the caller that placed the
    parameters holds it (the train step, the server).  ``None``: no
    change."""
    if specs is None:
        yield
        return
    _STACK.specs.append(specs)
    try:
        yield
    finally:
        _STACK.specs.pop()


def live_specs():
    """The innermost ``placed`` spec tree, or None."""
    return _STACK.specs[-1] if _STACK.specs else None


def swap(ctx: DistContext) -> DistContext:
    """Replace the innermost active context in place; returns the old one
    (the elastic re-slice makes the degraded mesh current mid-run, inside
    the caller's ``use`` block)."""
    if not _STACK.ctxs:
        raise RuntimeError("dist.swap: no active DistContext to replace")
    old = _STACK.ctxs[-1]
    _STACK.ctxs[-1] = ctx
    return old


# ---------------------------------------------------------------------------
# spec resolution (pure: reads mesh.axis_names and mesh.shape only)
# ---------------------------------------------------------------------------

def prune_specs(spec_tree, shapes, mesh):
    """Re-resolve a spec tree against a (possibly degraded) mesh.

    For each spec dimension, drop mesh axes the mesh no longer has and
    fall back to replicated when the leaf's (global) dim no longer divides
    the mapped axes' total.  ``shapes`` is a tree congruent with
    ``spec_tree`` of anything with ``shape`` and ``ndim`` (global shapes).
    """
    def one(spec, leaf):
        if not isinstance(spec, P):
            return spec
        ndim = len(leaf.shape)
        dims = list(spec) + [None] * (ndim - len(spec))
        out = []
        for i, entry in enumerate(dims):
            if entry is None:
                out.append(None)
                continue
            axes = axes_on_mesh(axes_tuple(entry), mesh)
            n = 1
            for a in axes:
                n *= mesh.shape[a]
            if not axes or n == 0 or leaf.shape[i] % n != 0:
                out.append(None)
            else:
                out.append(axes_entry(axes))
        return P(*out)

    return tree_map(one, spec_tree, shapes)


def resolve_spec(ctx: DistContext, logical_axes: Sequence[Optional[str]],
                 shape: Optional[Tuple[int, ...]] = None) -> Optional[P]:
    """Map per-dimension logical axes to a ``P`` under ``ctx``.

    A mesh axis is consumed at most once (first dimension wins); with
    ``shape`` given, a dimension keeps its sharding only if its size
    divides the mapped axes' total.  None when every dimension resolves
    replicated.
    """
    mesh_axes = set(ctx.mesh.axis_names)
    used: set = set()
    dims = []
    for i, name in enumerate(logical_axes):
        rule = ctx.rules.get(name) if isinstance(name, str) else None
        if rule is None:
            dims.append(None)
            continue
        axes = axes_tuple(rule)
        axes = tuple(a for a in axes if a in mesh_axes and a not in used)
        if not axes:
            dims.append(None)
            continue
        if shape is not None:
            n = 1
            for a in axes:
                n *= ctx.mesh.shape[a]
            if n == 0 or shape[i] % n != 0:
                dims.append(None)
                continue
        used.update(axes)
        dims.append(axes_entry(axes))
    if all(d is None for d in dims):
        return None
    return P(*dims)


# ---------------------------------------------------------------------------
# shards: the port's counterpart of NamedSharding + device_put
# ---------------------------------------------------------------------------

def _sharded_dims(spec: P):
    for i, entry in enumerate(spec):
        axes = axes_tuple(entry)
        if axes:
            yield i, axes


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a context: which block of a global tensor this rank
    holds (``cut``) and how the blocks join again (``gather``)."""

    ctx: DistContext
    spec: P

    def cut(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global tensor ``x`` (a view where the
        block is contiguous)."""
        for i, axes in _sharded_dims(self.spec):
            n = self.ctx.size(axes)
            if x.shape[i] % n:
                raise ValueError(f"dim {i} of size {x.shape[i]} does not "
                                 f"divide {axes} of size {n} ({self.spec})")
            m = x.shape[i] // n
            x = x.narrow(i, self.ctx.index(axes) * m, m)
        return x.contiguous()

    def global_shape(self, shape) -> Tuple[int, ...]:
        """The global shape of a block of ``shape`` held under this spec."""
        out = list(shape)
        for i, axes in _sharded_dims(self.spec):
            out[i] *= self.ctx.size(axes)
        return tuple(out)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global tensor from every rank's block (a collective over
        the spec's axes; no gradient)."""
        from repro_torch.dist import collectives
        with torch.no_grad():
            for i, axes in _sharded_dims(self.spec):
                x = collectives.all_gather(x, self.ctx, axes, dim=i)
        return x


def named_shardings(ctx: DistContext, spec_tree):
    """``Sharding``s on ``ctx`` for a spec tree (``None`` stays ``None``)."""
    return tree_map(lambda s: None if s is None else Sharding(ctx, s),
                    spec_tree)


def _shardings(tree, spec_tree, ctx):
    ctx = ctx if ctx is not None else current()
    if ctx is None:
        raise RuntimeError("no active DistContext and none given")
    return leaves_up_to(tree, named_shardings(ctx, spec_tree))


def place(tree, spec_tree, ctx: Optional[DistContext] = None, device=None):
    """Cut a tree of global tensors (or numpy arrays) into this rank's
    shards by ``spec_tree`` (already pruned to the mesh), moved to
    ``device`` (default: the context's)."""
    ctx = ctx if ctx is not None else current()
    dev = ctx.device if device is None else torch.device(device)
    flat = leaves(tree)
    out = []
    for x, sh in zip(flat, _shardings(tree, spec_tree, ctx)):
        if x is None:
            out.append(None)
            continue
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.asarray(x))
        if sh is not None:
            t = sh.cut(t)
        out.append(t.to(dev))
    return unflatten(tree, out)


def gather(tree, spec_tree, ctx: Optional[DistContext] = None):
    """The global tree from every rank's shards (a collective: every rank
    of the mesh calls it, in the same order)."""
    flat = leaves(tree)
    out = [x if (x is None or sh is None) else sh.gather(x)
           for x, sh in zip(flat, _shardings(tree, spec_tree, ctx))]
    return unflatten(tree, out)


def global_shapes(tree, spec_tree, ctx: Optional[DistContext] = None):
    """The global shapes of a tree of shards held under live (pruned)
    specs: each sharded dim times its axes' size."""
    flat = leaves(tree)
    out = [None if x is None else
           (tuple(x.shape) if sh is None else sh.global_shape(x.shape))
           for x, sh in zip(flat, _shardings(tree, spec_tree, ctx))]
    return unflatten(tree, [None if s is None else Shape(s) for s in out])


@dataclasses.dataclass(frozen=True)
class Shape:
    shape: Tuple[int, ...]

    @property
    def ndim(self) -> int:
        return len(self.shape)


# ---------------------------------------------------------------------------
# batch rows (contract point 1)
# ---------------------------------------------------------------------------

def batch_rows(ctx: DistContext, n: int) -> slice:
    """This rank's rows of a global batch of ``n`` rows: its block of the
    ``flat_batch`` split when ``n`` divides the mesh, else every row."""
    axes = ctx.batch_axes
    k = ctx.size(axes)
    if n % k:
        return slice(0, n)
    m = n // k
    i = ctx.index(axes)
    return slice(i * m, (i + 1) * m)


def batch_split(ctx: DistContext, n: int) -> bool:
    """Whether a global batch of ``n`` rows splits over the mesh."""
    return n % ctx.size(ctx.batch_axes) == 0


def rows(x: torch.Tensor, ctx: Optional[DistContext] = None):
    """``x``'s rows (dim 0) that this rank holds (all outside a context)."""
    ctx = ctx if ctx is not None else current()
    if ctx is None:
        return x
    return x[batch_rows(ctx, x.shape[0])]


def gather_rows(x: torch.Tensor, n: int,
                ctx: Optional[DistContext] = None, dim: int = 0):
    """The inverse of ``rows`` along ``dim``: the global ``n`` rows from
    every rank's block (differentiable; nothing to do when every rank
    holds every row)."""
    ctx = ctx if ctx is not None else current()
    if ctx is None or not batch_split(ctx, n):
        return x
    from repro_torch.dist import collectives
    return collectives.all_gather(x, ctx, ctx.batch_axes, dim=dim)


def shard(x: torch.Tensor, *logical_axes: Optional[str]):
    """The explicit cut of a replicated tensor to this rank's block of
    the layout named by per-dim logical axes (no-op outside a context).
    Callers own divisibility (``shard_if_divisible`` drops the dims that
    do not divide)."""
    ctx = current()
    if ctx is None:
        return x
    spec = resolve_spec(ctx, logical_axes)
    return x if spec is None else Sharding(ctx, spec).cut(x)


def shard_if_divisible(x: torch.Tensor, logical_axes: Sequence[Optional[str]]):
    """Like ``shard`` but keeps replicated any dim whose size does not
    divide the mapped mesh axes."""
    ctx = current()
    if ctx is None:
        return x
    spec = resolve_spec(ctx, logical_axes, shape=tuple(x.shape))
    return x if spec is None else Sharding(ctx, spec).cut(x)
