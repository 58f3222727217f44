"""Parameter trees: nested dicts, lists and tuples with tensors (or None)
at the leaves, as the JAX package's pytrees, and the few ``jax.tree``
functions the port needs.  Dicts are walked in sorted key order, as
``jax.tree`` walks them; ``None`` is a leaf here (a frozen leaf's missing
gradient), where ``jax.tree`` would see an empty subtree."""

from __future__ import annotations

from typing import Callable, List


def _walk(struct, tree, out: list) -> None:
    if isinstance(struct, dict):
        if not isinstance(tree, dict) or set(tree) != set(struct):
            raise ValueError("trees differ in structure: dict keys")
        for k in sorted(struct):
            _walk(struct[k], tree[k], out)
    elif isinstance(struct, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(struct):
            raise ValueError("trees differ in structure: sequence length")
        for s, t in zip(struct, tree):
            _walk(s, t, out)
    else:
        out.append(tree)


def leaves_up_to(struct, tree) -> List:
    """The subtrees of ``tree`` at the leaves of ``struct`` (whose
    containers ``tree`` must repeat), in ``struct``'s leaf order."""
    out: list = []
    _walk(struct, tree, out)
    return out


def leaves(tree) -> List:
    """The leaves of ``tree``, dicts in sorted key order."""
    return leaves_up_to(tree, tree)


def unflatten(struct, values) -> object:
    """``struct``'s containers with ``values`` at its leaves, in leaf
    order (each value is placed as it is, even a container)."""
    it = iter(values)

    def build(s):
        if isinstance(s, dict):
            built = {k: build(s[k]) for k in sorted(s)}
            return {k: built[k] for k in s}
        if isinstance(s, (list, tuple)):
            return type(s)(build(v) for v in s)
        return next(it)

    out = build(struct)
    if next(it, it) is not it:
        raise ValueError("more values than leaves")
    return out


def tree_map(fn: Callable, tree, *rest) -> object:
    """``fn`` over the leaves of ``tree`` and the matching subtrees of
    ``rest``, in ``tree``'s structure."""
    others = [leaves_up_to(tree, r) for r in rest]
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree), *others)])
