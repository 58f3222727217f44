"""Carry the JAX package's parameters into the port.

``params_from_numpy(tree, device)`` turns ``repro``'s parameter tree, given
as numpy arrays (``jax.tree.map(np.asarray, params)`` on the JAX side), into
the port's tree with the same keys: dicts, lists, dense ``w`` as
``[d_in, d_out]`` and ``embedding.memory`` as a 1-D array.  Every leaf keeps
its numpy dtype: ``qrobe``'s int8 ``codes`` arrive as ``torch.int8``, its
f32 ``scale`` and ``delta`` as ``torch.float32``.  The same call carries an
optimizer state or a whole train state (``{"params", "opt", "step"}``)
across.  ``params_onto_mesh`` carries such a tree onto a
``repro_torch.dist`` mesh: each rank keeps its shards by a spec tree.
``tree_to_numpy`` is the way back, for comparing trees.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_numpy(tree, device=None):
    """Map every array leaf of ``tree`` (nested dicts, lists, tuples) to a
    tensor on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return torch.from_numpy(np.array(t)).to(dev)

    return walk(tree)


def params_onto_mesh(tree, spec_tree, ctx=None, device=None):
    """``params_from_numpy`` onto a mesh: every rank cuts its shards of the
    global numpy ``tree`` by ``spec_tree`` (pruned to the mesh) and moves
    only those to ``device`` (default: the mesh's).  ``ctx``: the active
    context by default."""
    from repro_torch.dist import api as dist
    host = params_from_numpy(tree, "cpu")
    return dist.place(host, spec_tree, ctx, device=device)


def tree_to_numpy(tree):
    """Map every tensor leaf of ``tree`` to a numpy array on the host (bf16
    as f32: numpy has no bf16); other leaves pass through."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu()
            if t.dtype == torch.bfloat16:
                t = t.to(torch.float32)
            return t.numpy()
        return t

    return walk(tree)
