"""``hashed`` — the quotient-remainder (QR) compositional hashing baseline
(PyTorch port of ``repro.nn.embedding_backends.hashed``).

Each field keeps ``m`` remainder buckets and ``ceil(vocab/m)`` quotient
buckets; row ``x``'s embedding is the elementwise product

    e(x) = Q[x // m] * R[x % m]

which is collision-free as a pair while training only O(m + vocab/m) rows
per field.  Both tables are concatenated across fields and replicated, so
lookups are local.  A lookup runs the ``qr_lookup`` op: on the card the
Hopper kernel computes the indices, both gathers and the product in one
pass.  ``m`` defaults to the power of two nearest √(max vocab).

The serving tier's hot-row cache fronts it: ``cacheable_rows`` hands the
cache the composed rows of the asked ids through the same lookup (on the
card, the ``qr_lookup`` kernel on the tables' device; only those rows
come to the host), and ``affected_rows`` widens a push's invalidation to
the ids that share a quotient or remainder bucket with a trained one.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.dist.api import P
from repro_torch.kernels.ops import qr_lookup
from repro_torch.nn.embedding_backends.base import (EmbeddingBackend,
                                                    register_backend)


def default_buckets(vocab_sizes: Tuple[int, ...]) -> int:
    """Power of two nearest √(max vocab) — minimizes m + max_v/m."""
    v = max(vocab_sizes)
    m = 1
    while m * m < v:
        m *= 2
    return max(2, m)


@functools.lru_cache(maxsize=128)
def qr_layout(vocab_sizes: Tuple[int, ...], m: int):
    """(q_rows, q_offsets, r_offsets): concatenated-table row layout."""
    q_rows = tuple(-(-int(v) // m) for v in vocab_sizes)
    q_off = np.concatenate([[0], np.cumsum(q_rows)[:-1]]).astype(np.int64)
    r_off = np.arange(len(vocab_sizes), dtype=np.int64) * m
    return q_rows, q_off, r_off


def _m(spec) -> int:
    return int(spec.hashed_buckets) if spec.hashed_buckets > 0 \
        else default_buckets(spec.vocab_sizes)


class HashedBackend(EmbeddingBackend):
    name = "hashed"

    def init(self, generator, spec, device, pad_rows_to: int = 1) -> dict:
        m = _m(spec)
        q_rows, _, _ = qr_layout(spec.vocab_sizes, m)
        # product composition: |q·r| ~ 1/√dim, the full table's row scale,
        # once both factors carry its square root
        s = float(np.sqrt(1.0 / np.sqrt(spec.dim)))

        def uniform(rows):
            w = torch.empty((rows, spec.dim), dtype=torch.float32,
                            device=generator.device)
            return w.uniform_(-s, s, generator=generator).to(device)

        return {"q_table": uniform(sum(q_rows)),
                "r_table": uniform(m * spec.n_fields)}

    def lookup(self, params, spec, idx, fields=None):
        fields = fields if fields is not None else tuple(range(spec.n_fields))
        m = _m(spec)
        _, q_off, r_off = qr_layout(spec.vocab_sizes, m)
        return qr_lookup(params["q_table"], params["r_table"], idx,
                         tuple(int(q_off[f]) for f in fields),
                         tuple(int(r_off[f]) for f in fields), m)

    def cacheable_rows(self, params, spec, field: int,
                       ids: np.ndarray) -> np.ndarray:
        """Hot-row-cache hook: the composed rows Q[x//m] * R[x%m] of
        ``ids`` in ``field``, as host f32.  They come from ``lookup`` on
        the tables' device (one ``qr_lookup`` launch on the card), so they
        are the rows the uncached lookup computes, bit for bit; only the
        asked rows are copied to the host.  Caching the *composed* row
        also skips the recomposition multiply on every hot hit."""
        q = params["q_table"]
        idx = torch.as_tensor(np.asarray(ids, np.int64).astype(np.int32),
                              device=q.device)[:, None]
        with torch.no_grad():
            rows = self.lookup(params, spec, idx, fields=(field,))
        return rows[:, 0].cpu().numpy()

    def affected_rows(self, spec, field: int, touched: np.ndarray,
                      candidates: np.ndarray) -> np.ndarray:
        """Push-invalidation hook: training id x moves bucket rows
        Q[x//m] and R[x%m], so every candidate sharing a quotient OR
        remainder bucket with a touched id has a changed composed row —
        exact-id invalidation would leave those cache entries stale."""
        m = _m(spec)
        t = np.asarray(touched, np.int64).ravel()
        c = np.asarray(candidates, np.int64).ravel()
        return (np.isin(c // m, np.unique(t // m))
                | np.isin(c % m, np.unique(t % m)))

    def param_specs(self, spec, rules, mesh=None) -> dict:
        # replicated on every mesh: a degraded mesh changes nothing, the
        # elastic restore re-broadcasts both tables to the survivors
        return {"q_table": P(), "r_table": P()}

    def param_count(self, spec) -> int:
        m = _m(spec)
        q_rows, _, _ = qr_layout(spec.vocab_sizes, m)
        return (sum(q_rows) + m * spec.n_fields) * spec.dim

    def cost(self, spec, batch: int) -> dict:
        # two dim-row fetches + one elementwise product per (example, field)
        return {"params": self.param_count(spec),
                "bytes_fetched": batch * spec.n_fields * 2 * spec.dim * 4,
                "flops": batch * spec.n_fields * spec.dim}


register_backend(HashedBackend())
