"""The ``EmbeddingBackend`` protocol and registry (PyTorch port of
``repro.nn.embedding_backends.base``).

An embedding *backend* is one substrate for the model's categorical
features: a way to store the logical [total_rows, dim] table and answer
row lookups.

* ``init(generator, spec, device, pad_rows_to)`` -> parameter dict
* ``lookup(params, spec, idx, fields)`` -> [B, F', dim] embeddings
* ``lookup_bag(params, spec, idx, ...)``-> pooled multi-hot lookups
* ``lookup_dist(params, spec, idx, pspec=)`` -> the distributed lookup
  under the active ``repro_torch.dist`` context, on the parameters' live
  layout ``pspec``: global ids in, the rank's rows
  (``dist.api.batch_rows``) out; the collectives live in the backend
* ``param_specs(spec, rules, mesh=None)`` -> the ``P`` tree of the
  parameters (``mesh`` re-resolves the layout against a concrete,
  possibly degraded, mesh: the elastic re-slice contract)
* ``cost(spec, batch)``                 -> {"params", "bytes_fetched",
  "flops"}, the substrate's own cost model
* ``local_batch``                       -> True when lookups need no
  model-axis exchange, so recsys batches may cut over the whole mesh

``get_backend(name)`` is the only dispatch point.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

# the axis-normalization helpers live in dist.api (the spec trees the
# backends build must agree with the ones prune_specs re-resolves)
from repro_torch.dist.api import (axes_entry, axes_on_mesh,  # noqa: F401
                                  axes_tuple)

#: backends of the JAX package that this package does not have yet
NOT_YET_PORTED: Tuple[str, ...] = ()


class EmbeddingBackend:
    """Base class: generic bag pooling + replicated-local distribution."""

    name: str = ""
    #: lookups are device-local (no model-axis embedding exchange): the
    #: batch may cut over every mesh axis (the ``flat_batch`` rule)
    local_batch: bool = True
    #: optional serve fast path: a backend that fuses lookup -> bag pooling
    #: -> dot interaction into one kernel overrides this with a method
    #: ``fused_serve(params, spec, idx, bot) -> [B, (F+1)·F/2]`` (or one
    #: returning None when it cannot fuse); ``None`` means no fused path
    fused_serve = None
    #: optional serving-tier hot-row-cache hook, ``cacheable_rows(params,
    #: spec, field, ids) -> [n, dim]``; ``None`` declines the cache
    cacheable_rows = None
    #: optional push-invalidation companion to ``cacheable_rows``,
    #: ``affected_rows(spec, field, touched_ids, candidate_ids) -> bool
    #: mask over candidates``: which cached rows a training update of the
    #: touched ids changed, for a backend whose stored rows are shared
    #: across ids; ``None`` means exact id match
    affected_rows = None
    #: optional post-optimizer projection hook, ``project(params, spec)``;
    #: ``None`` means the parameters are their own representation
    project = None

    def validate(self, spec) -> None:
        """Raise if ``spec`` is not usable with this backend."""

    def init(self, generator: torch.Generator, spec, device,
             pad_rows_to: int = 1) -> dict:
        """Parameters drawn from ``generator``, on ``device``;
        ``pad_rows_to`` rounds a row table's rows up to a multiple of it
        (read only by ``full``)."""
        raise NotImplementedError

    def lookup(self, params: dict, spec, idx: torch.Tensor,
               fields: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
        """idx [B, F'] int32 per-field row ids -> [B, F', dim]."""
        raise NotImplementedError

    def lookup_bag(self, params: dict, spec, idx: torch.Tensor,
                   combiner: str = "sum",
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """idx [B, F, bag] (-1 padded) -> [B, F, dim].

        Pools via gather + masked (weighted) reduction; ``weights``
        [B, F, bag] are per-sample bag weights and ``combiner="mean"``
        divides by the weight mass.
        """
        b, f, bag = idx.shape
        mask = idx >= 0
        safe = torch.where(mask, idx, torch.zeros_like(idx))
        # fold the bag into the batch so each column keeps its field id
        flat = safe.transpose(1, 2).reshape(b * bag, f)
        emb = self.lookup(params, spec, flat).reshape(
            b, bag, f, spec.dim).transpose(1, 2)        # [b, f, bag, dim]
        w = mask.to(emb.dtype)
        if weights is not None:
            w = w * weights.to(emb.dtype)
        out = (emb * w[..., None]).sum(dim=2)
        if combiner == "mean":
            # divide by the actual weight mass; empty bags pool to zero
            mass = w.sum(dim=2, keepdim=True).to(out.dtype)
            out = torch.where(mass > 0,
                              out / torch.where(mass > 0, mass,
                                                torch.ones_like(mass)),
                              torch.zeros_like(out))
        elif combiner != "sum":
            raise ValueError(f"unknown combiner {combiner}")
        return out

    def lookup_dist(self, params: dict, spec, idx: torch.Tensor, *,
                    compute_dtype=None,
                    fields: Optional[Tuple[int, ...]] = None,
                    pspec: Optional[dict] = None) -> torch.Tensor:
        """Lookup under the active DistContext (no context: local).

        ``idx`` is the global [B, F'] id batch; the result is the rank's
        rows of it (``dist.api.batch_rows``).  ``pspec``: the live ``P``
        dict of ``params`` (None: ``param_specs`` on the current mesh).
        Default: the parameters are replicated and the lookup is local on
        those rows -- no embedding collective.
        """
        from repro_torch.dist import api as dist
        return self.lookup(params, spec, dist.rows(idx), fields)

    def param_specs(self, spec, rules: Dict, mesh=None) -> dict:
        """``P`` tree matching ``init``'s parameter dict; ``mesh`` drops
        the axes a degraded mesh no longer carries (shape divisibility on
        the survivors is ``dist.api.prune_specs``'s job)."""
        raise NotImplementedError

    def param_count(self, spec) -> int:
        raise NotImplementedError

    def cost(self, spec, batch: int) -> dict:
        """Per-step cost model for ``batch`` examples: trained parameter
        count, device bytes fetched by the lookups, lookup FLOPs."""
        raise NotImplementedError


_REGISTRY: Dict[str, EmbeddingBackend] = {}


def register_backend(backend: EmbeddingBackend) -> EmbeddingBackend:
    if not backend.name:
        raise ValueError("backend must carry a non-empty .name")
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: str) -> EmbeddingBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        later = (f"; {sorted(NOT_YET_PORTED)} are not yet ported"
                 if name in NOT_YET_PORTED else "")
        raise KeyError(f"unknown embedding backend {name!r}; registered: "
                       f"{backend_names()}{later}") from None


def backend_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
