"""Spec trees for the parameter families the port has (PyTorch port of
``repro.dist.param_specs``).

* ``recsys_specs``     -- dense towers replicated; the ``embedding``
  subtree comes from its backend's ``param_specs``: the full table
  row-sharded over ``model`` (or the whole mesh with ``placement="2d"``),
  the ROBE array replicated (or ``model``-sharded, ZeRO-3), qrobe, hashed
  and tt replicated.
* ``replicated_specs`` -- ``P()`` everywhere (pure data parallelism).
* ``state_specs``      -- mirrors a param spec tree onto optimizer state
  (moments shard like their parameters; anything else is replicated).

``transformer_specs`` and its ``_fsdp_extend`` wait for the LM family
(ROADMAP module item 7): the port has no transformer parameters yet.

The functions take shape trees (tensors, numpy arrays or anything with
``shape``/``ndim``); ``None`` leaves (the port's frozen-leaf marker) keep
``None`` specs, where ``jax.tree`` sees an empty subtree.
"""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.dist.api import P
from repro_torch.tree import leaves_up_to, tree_map, unflatten


def replicated_specs(pshapes) -> Any:
    """P() for every leaf -- pure data-parallel parameters."""
    return tree_map(lambda x: None if x is None else P(), pshapes)


def recsys_specs(pshapes, rules: Dict, embedding_spec=None, *,
                 mesh=None) -> Any:
    """Dense towers replicated; the ``embedding`` subtree delegated to
    ``get_backend(embedding_spec.kind).param_specs`` (each substrate owns
    its layout: the full table's whole-mesh placement is the spec's
    ``placement="2d"``); ``mesh`` re-resolves the backend's layout
    against a concrete (possibly degraded) mesh."""
    from repro_torch.nn.embedding_backends import get_backend

    out = replicated_specs(pshapes)
    if isinstance(out, dict) and "embedding" in out:
        if embedding_spec is None or not hasattr(embedding_spec, "kind"):
            # never silently replicate a (possibly 100 GB) table
            raise ValueError(
                "recsys_specs requires embedding_spec= (an EmbeddingSpec) "
                "for parameter trees with an 'embedding' subtree -- its "
                "backend owns the layout")
        spec = embedding_spec
        out = dict(out)
        out["embedding"] = get_backend(spec.kind).param_specs(spec, rules,
                                                              mesh=mesh)
    return out


def state_specs(pspecs, opt_state) -> Any:
    """Mirror ``pspecs`` onto an optimizer-state tree: moments have the
    params' structure and inherit their specs one to one; a state family
    of another per-leaf structure (Adafactor's factored {vr, vc}) falls
    back to replicated."""

    def mirror(sub):
        try:
            sub_leaves = leaves_up_to(pspecs, sub)
        except ValueError:
            return None
        out = []
        for s, leaf in zip(leaves_up_to(pspecs, pspecs), sub_leaves):
            if not hasattr(leaf, "ndim"):
                return None                  # nested deeper than params
            out.append(s if len(s) <= leaf.ndim else P())
        return unflatten(pspecs, out)

    def fallback(sub):
        return replicated_specs(sub)

    if isinstance(opt_state, dict):
        return {k: (m if (m := mirror(sub)) is not None else fallback(sub))
                for k, sub in opt_state.items()}
    m = mirror(opt_state)
    return m if m is not None else fallback(opt_state)
