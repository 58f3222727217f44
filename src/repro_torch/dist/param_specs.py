"""Spec trees for the parameter families the port has (PyTorch port of
``repro.dist.param_specs``).

* ``recsys_specs``     -- dense towers replicated; the ``embedding``
  subtree comes from its backend's ``param_specs``: the full table
  row-sharded over ``model`` (or the whole mesh with ``placement="2d"``),
  the ROBE array replicated (or ``model``-sharded, ZeRO-3), qrobe, hashed
  and tt replicated.
* ``transformer_specs`` -- Megatron tensor parallelism for the LM tree:
  q/k/v (``wq wk wv w_uq w_uk w_uv`` and their biases) and the FFN's
  gate/up column-parallel, ``wo`` and the FFN's down row-parallel, the
  embedding table vocab-row sharded, ``lm_head`` vocab-column sharded,
  the MoE expert stacks over ``expert`` (shared experts replicated, as
  ``nn.moe.moe_param_specs``); ``fsdp=True`` also shards each large
  leaf's largest free dim over the data axes (``_fsdp_extend``).
* ``replicated_specs`` -- ``P()`` everywhere (pure data parallelism; the
  GatedGCN).
* ``state_specs``      -- mirrors a param spec tree onto optimizer state
  (moments shard like their parameters; anything else is replicated).

The functions take shape trees (tensors, numpy arrays or anything with
``shape``/``ndim``); ``None`` leaves (the port's frozen-leaf marker) keep
``None`` specs, where ``jax.tree`` sees an empty subtree.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from repro_torch.dist.api import P, axes_entry, axes_tuple
from repro_torch.tree import leaves_up_to, tree_map, unflatten

# dense sublayers of the attention blocks, classified Megatron-style
_COL_W = {"wq", "wk", "wv", "w_q", "w_uq", "w_uk", "w_uv"}
_ROW_W = {"wo"}


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


def _fsdp_extend(spec: P, leaf, dp: tuple, min_size: int = 1 << 20) -> P:
    """Shard the largest still-replicated dim of a leaf of at least
    ``min_size`` elements over the data axes ``dp``."""
    if not dp or int(np.prod(leaf.shape)) < min_size:
        return spec
    dims = list(spec) + [None] * (len(leaf.shape) - len(spec))
    free = [i for i, d in enumerate(dims) if d is None]
    if not free:
        return spec
    i = max(free, key=lambda j: leaf.shape[j])
    dims[i] = axes_entry(dp)
    return P(*dims)


def _with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def transformer_specs(pshapes, rules: Dict, fsdp: bool = False) -> Any:
    """Megatron-TP specs for the LM parameter tree (the scanned
    ``layers`` carry a leading L dim, the unrolled ``dense_layers`` do
    not)."""
    mlp = axes_entry(axes_tuple(rules.get("mlp", "model")) or ("model",))
    vocab = axes_entry(axes_tuple(rules.get("vocab", "model")) or ("model",))
    ex = axes_entry(axes_tuple(rules.get("expert", "model")) or ("model",))
    dp = axes_tuple(rules.get("batch"))

    def leaf_spec(keys, leaf):
        if leaf is None:
            return None
        nd = len(leaf.shape)
        off = 1 if ("layers" in keys and "dense_layers" not in keys) else 0
        dims = [None] * nd
        name = keys[-1] if keys else ""
        parent = keys[-2] if len(keys) >= 2 else ""
        if "embed" in keys:
            if name == "table" and nd >= 1:
                dims[0] = vocab                       # vocab-row sharded
        elif name == "lm_head" and nd >= 1:
            dims[nd - 1] = vocab
        elif "moe" in keys and "shared" not in keys:
            if name in ("w_gate", "w_up", "w_down") and off < nd:
                dims[off] = ex                        # [.., E, d, f]
        elif "ffn" in keys:
            if name in ("w_gate", "w_up") and nd >= 1:
                dims[nd - 1] = mlp                    # column-parallel
            elif name == "w_down" and off < nd:
                dims[off] = mlp                       # row-parallel
        elif "attn" in keys:
            if name in ("w", "b") and parent in _COL_W and nd >= 1:
                dims[nd - 1] = mlp
            elif name == "w" and parent in _ROW_W and off < nd:
                dims[off] = mlp
        spec = P(*dims)
        if fsdp:
            spec = _fsdp_extend(spec, leaf, dp)
        return spec

    return _with_path(leaf_spec, pshapes)


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
