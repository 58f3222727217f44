"""Gradient compression for the data-parallel all-reduce (PyTorch port of
``repro.train.compression``).

* ``bf16``  -- cast-compressed all-reduce with f32 **error feedback**: the
  quantization residual is carried in the train state and re-added next
  step, so the compression bias does not accumulate.
* ``int8``  -- per-tensor max-scaled int8 all-reduce + error feedback; the
  scale is shared through an all-reduce MAX so every rank quantizes onto
  one grid, and the codes are summed as int32.
* ``none``  -- plain f32 all-reduce.

``compressed_psum`` runs over the data axes of the active context
(``train.train_loop``'s step hands it each data shard's gradient);
``quantize`` is one rank's half of it, the formulas alone.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.dist import api as dist
from repro_torch.dist import collectives as coll
from repro_torch.tree import tree_map, unflatten, leaves

F32 = torch.float32


def quantize(g: torch.Tensor, r: Optional[torch.Tensor], method: str,
             scale: Optional[torch.Tensor] = None):
    """One rank's compressed payload of ``g`` with residual ``r``:
    (payload, new residual).  ``bf16``: the bf16 cast; ``int8``: the int8
    codes on the grid ``scale`` (the ranks' shared maximum of
    ``local_scale``)."""
    gf = g.to(F32) + (r if r is not None else 0.0)
    if method == "bf16":
        q = gf.to(torch.bfloat16)
        return q, gf - q.to(F32)
    if method == "int8":
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        return q, gf - q.to(F32) * scale
    raise ValueError(f"unknown compression {method}")


def local_scale(g: torch.Tensor, r: Optional[torch.Tensor]) -> torch.Tensor:
    """This rank's int8 grid step: max |g + r| / 127 (at least 1e-12/127)."""
    gf = g.to(F32) + (r if r is not None else 0.0)
    return torch.clamp_min(torch.max(torch.abs(gf)), 1e-12) / 127.0


def compressed_psum(grads, residual, axes, method: str = "none", ctx=None):
    """All-reduce ``grads`` (mean) over the mesh ``axes`` of ``ctx`` (the
    active context by default), with optional compression.

    residual: a tree like grads (f32) carrying error feedback, or None.
    Returns (reduced grads f32, new residual).
    """
    ctx = ctx if ctx is not None else dist.current()
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    n = ctx.size(axes)

    if method == "none":
        return tree_map(lambda g: coll.all_reduce_(g.to(F32).clone(), ctx,
                                                   axes) / n,
                        grads), residual

    if method not in ("bf16", "int8"):
        raise ValueError(f"unknown compression {method}")
    if residual is None:
        residual = tree_map(lambda g: torch.zeros_like(g, dtype=F32), grads)

    def one(g, r):
        scale = None
        if method == "int8":
            # shared scale via a scalar all-reduce MAX: every rank
            # quantizes onto the same grid and the int sum reconstructs
            scale = coll.all_reduce_(local_scale(g, r).reshape(1), ctx,
                                     axes, "max")[0]
        q, new_r = quantize(g, r, method, scale)
        if method == "bf16":
            red = coll.all_reduce_(q, ctx, axes).to(F32) / n
        else:
            # int accumulation (values <= 127·n)
            red = coll.all_reduce_(q.to(torch.int32), ctx, axes).to(F32) \
                * scale / n
        return red, new_r

    pairs = [one(g, r) for g, r in zip(leaves(grads), leaves(residual))]
    return (unflatten(grads, [p[0] for p in pairs]),
            unflatten(grads, [p[1] for p in pairs]))
