"""Embedding front-end: ``EmbeddingSpec`` + the ``EmbeddingBackend`` API
(PyTorch port of ``repro.nn.embeddings``).

Every substrate is an ``EmbeddingBackend`` registered by name and selected
via ``EmbeddingSpec.kind``; ``get_backend(spec.kind)`` is the only
dispatch point.  ``embedding_lookup`` / ``embedding_lookup_bag`` /
``embedding_lookup_dist`` are thin wrappers over the backend.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.robe import RobeSpec
from repro_torch.nn.embedding_backends import backend_names, get_backend
from repro_torch.nn.embedding_backends.full import full_lookup_sharded_body
from repro_torch.nn.embedding_backends.robe import robe_allgather_body

__all__ = ["EmbeddingSpec", "embedding_init", "embedding_lookup",
           "embedding_lookup_bag", "embedding_lookup_dist", "get_backend",
           "backend_names", "full_lookup_sharded_body",
           "robe_allgather_body"]


@dataclasses.dataclass(frozen=True)
class EmbeddingSpec:
    vocab_sizes: Tuple[int, ...]          # rows per categorical field
    dim: int
    kind: str = "robe"                    # any registered backend name
    robe: Optional[RobeSpec] = None
    placement: str = "default"            # backend-interpreted layout knob
    hashed_buckets: int = 0               # QR remainder buckets (0 = auto)
    tt_rank: int = 0                      # TT core rank (0 = default 8)

    def __post_init__(self):
        object.__setattr__(self, "vocab_sizes",
                           tuple(int(v) for v in self.vocab_sizes))
        if not self.vocab_sizes:
            raise ValueError("vocab_sizes must be non-empty")
        if any(v <= 0 for v in self.vocab_sizes):
            raise ValueError(f"vocab_sizes must be positive, got "
                             f"{self.vocab_sizes}")
        if self.dim <= 0:
            raise ValueError(f"dim must be positive, got {self.dim}")
        get_backend(self.kind).validate(self)

    @property
    def n_fields(self) -> int:
        return len(self.vocab_sizes)

    @property
    def total_rows(self) -> int:
        return int(sum(self.vocab_sizes))

    @functools.cached_property
    def offsets(self) -> np.ndarray:
        """Per-field row offsets into the concatenated logical table."""
        return np.concatenate([[0], np.cumsum(self.vocab_sizes)[:-1]]
                              ).astype(np.int64)

    @property
    def param_count(self) -> int:
        return get_backend(self.kind).param_count(self)

    @property
    def compression(self) -> float:
        return (self.total_rows * self.dim) / max(1, self.param_count)


def embedding_init(generator: torch.Generator, spec: EmbeddingSpec,
                   device, pad_rows_to: int = 1) -> dict:
    return get_backend(spec.kind).init(generator, spec, device,
                                       pad_rows_to=pad_rows_to)


def embedding_lookup(params: dict, spec: EmbeddingSpec, idx: torch.Tensor,
                     fields: Optional[Tuple[int, ...]] = None
                     ) -> torch.Tensor:
    """idx [B, F'] int32 per-field row ids -> [B, F', dim] embeddings;
    ``fields`` selects a subset of the spec's fields (default: all)."""
    return get_backend(spec.kind).lookup(params, spec, idx, fields)


def embedding_lookup_bag(params: dict, spec: EmbeddingSpec,
                         idx: torch.Tensor, combiner: str = "sum",
                         weights: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """idx [B, F, bag] (-1 padded) -> [B, F, dim]; optional per-sample
    ``weights`` [B, F, bag] (mean divides by the weight mass)."""
    return get_backend(spec.kind).lookup_bag(params, spec, idx,
                                             combiner=combiner,
                                             weights=weights)


def embedding_lookup_dist(params: dict, spec: EmbeddingSpec,
                          idx: torch.Tensor, compute_dtype=None,
                          fields: Optional[Tuple[int, ...]] = None,
                          pspec: Optional[dict] = None) -> torch.Tensor:
    """Distributed lookup under the active ``repro_torch.dist`` context:
    the global ids ``idx`` in, this rank's rows out (a local lookup outside
    a context).  ``pspec``: the live ``P`` dict of ``params`` (None: the
    backend's own layout).  The collectives live in the backends."""
    return get_backend(spec.kind).lookup_dist(params, spec, idx,
                                              compute_dtype=compute_dtype,
                                              fields=fields, pspec=pspec)
