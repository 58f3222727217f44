"""Synthetic Criteo-like CTR stream with planted, learnable structure
(numpy only; a copy of ``repro.data.synthetic_ctr``'s streams, so both
packages see the same batches from the same seed).

CriteoTB / Criteo-Kaggle are not downloadable offline (DESIGN.md §6.4), so
the data layer generates a deterministic, step-indexed stream:

* per-field categorical ids drawn from a Zipf-ish power law (the skew that
  makes ROBE-style hashing interesting: a few hot rows, a huge cold tail);
* labels ~ Bernoulli(σ(planted score)) where the score is a fixed random
  per-(field, value) contribution (cheap hash-based pseudo-embedding) plus a
  linear term on the dense features — so a model that learns per-value
  embeddings can genuinely push AUC well above 0.5.

**Concept drift** (``drift_period > 0``): production CTR traffic is
non-stationary — CAFE (PAPERS.md) makes the case that skewed *and
drifting* feature distributions are the real workload.  The stream models
it as discrete phases of ``drift_period`` steps each
(``phase = step // drift_period``):

* *id drift* (covariate shift) — the zipf head rotates by
  ``drift_fraction × vocab`` rows per phase, so each phase has a different
  hot set (a hot-row cache warmed on phase k misses on phase k+1; an
  online trainer keeps touching fresh rows);
* *label drift* (concept shift) — the planted per-(field, value) score is
  re-drawn per phase (the phase salts the score hash), so P(y|x) itself
  moves and a frozen model's logloss degrades until the next model push.

Determinism: ``batch_at(step)`` is a pure function of (seed, step) — exactly
what fault-tolerant resume needs (restart at step k reproduces the stream).
Drift keeps that property: the phase is a pure function of step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CtrDataConfig:
    vocab_sizes: Tuple[int, ...]
    n_dense: int = 0
    batch_size: int = 256
    zipf_exponent: float = 1.05
    label_temperature: float = 1.2
    seed: int = 1234
    multi_hot: int = 0                 # >0: bag size per field
    drift_period: int = 0              # steps per drift phase (0 = stationary)
    drift_fraction: float = 0.35       # zipf-head rotation per phase (× vocab)


def _field_value_score(field: np.ndarray, value: np.ndarray,
                       seed: int) -> np.ndarray:
    """Deterministic pseudo-random score in [-1,1] per (field, value)."""
    with np.errstate(over="ignore"):           # uint64 wraparound intended
        h = (value.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
             + field.astype(np.uint64) * np.uint64(0xBF58476D1CE4E5B9)
             + np.uint64(seed % 2**32) * np.uint64(0x94D049BB133111EB))
        h ^= h >> np.uint64(29)
        h *= np.uint64(0xBF58476D1CE4E5B9)
        h ^= h >> np.uint64(32)
    return (h.astype(np.float64) / 2 ** 64) * 2.0 - 1.0


class CtrStream:
    """Step-indexed synthetic CTR batches (host-side, numpy)."""

    def __init__(self, cfg: CtrDataConfig):
        self.cfg = cfg
        self._vocab = np.asarray(cfg.vocab_sizes, np.int64)
        self._fields = np.arange(len(cfg.vocab_sizes), dtype=np.int64)

    def phase_at(self, step: int) -> int:
        """Drift phase of ``step`` (0 when the stream is stationary)."""
        p = self.cfg.drift_period
        return int(step) // p if p > 0 else 0

    def hot_offset(self, phase: int) -> np.ndarray:
        """Per-field rotation of the zipf head for ``phase`` ([F] int64)."""
        shift = np.maximum(1, (self.cfg.drift_fraction
                               * self._vocab).astype(np.int64))
        return (phase * shift) % self._vocab

    def _sample_ids(self, rs: np.random.RandomState, n: int,
                    phase: int = 0) -> np.ndarray:
        """Power-law ids per field via inverse-CDF on u^alpha; under drift
        the head (densest ids, near 0) rotates by ``hot_offset(phase)``."""
        f = len(self._vocab)
        u = rs.random_sample((n, f))
        skew = u ** (1.0 / max(1e-6, self.cfg.zipf_exponent)) \
            if self.cfg.zipf_exponent != 1.0 else u
        # heavier head: square the uniform
        ids = (skew * skew * self._vocab[None, :]).astype(np.int64)
        ids = np.minimum(ids, self._vocab[None, :] - 1)
        if phase:
            ids = (ids + self.hot_offset(phase)[None, :]) % self._vocab[None, :]
        return ids

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rs = np.random.RandomState((cfg.seed * 1_000_003 + step) % 2 ** 31)
        n = cfg.batch_size
        phase = self.phase_at(step)
        ids = self._sample_ids(rs, n, phase)                # [B, F]
        # label drift: the phase salts the planted score hash, so P(y|x)
        # itself moves between phases (concept shift, not just covariate)
        score = _field_value_score(
            np.broadcast_to(self._fields[None, :], ids.shape), ids,
            cfg.seed + phase * 7919).mean(axis=1) * 4.0
        batch = {}
        if cfg.n_dense:
            dense = rs.randn(n, cfg.n_dense).astype(np.float32)
            score = score + 0.3 * dense[:, :min(4, cfg.n_dense)].mean(axis=1)
            batch["dense"] = dense
        logits = score / cfg.label_temperature
        prob = 1.0 / (1.0 + np.exp(-logits))
        batch["label"] = (rs.random_sample(n) < prob).astype(np.int32)
        batch["sparse"] = ids.astype(np.int32)
        if cfg.multi_hot:
            bags = np.stack([self._sample_ids(rs, n, phase)
                             for _ in range(cfg.multi_hot)], axis=-1)
            batch["sparse_bag"] = bags.astype(np.int32)
        return batch


def poisson_arrivals(rate_hz: float, n: int, seed: int = 0) -> np.ndarray:
    """Open-loop Poisson arrival process: ``n`` cumulative arrival times
    (seconds, starting after t=0) at ``rate_hz`` mean offered load.

    Deterministic in (rate, n, seed), the same floats as the JAX
    package's: the serving replay's virtual timeline
    (``repro_torch.serve.replay``) depends on replayable arrivals the way
    ``batch_at`` depends on (seed, step).  Open-loop means arrivals never
    wait on completions: offered load is a property of the trace, not of
    the server.
    """
    if rate_hz <= 0:
        raise ValueError(f"rate_hz must be positive, got {rate_hz}")
    rs = np.random.RandomState(seed % 2 ** 31)
    return np.cumsum(rs.exponential(1.0 / rate_hz, size=n))


class RequestStream:
    """Per-request view over ``CtrStream``: request ``i`` is row
    ``i % batch_size`` of ``batch_at(i // batch_size)`` with the label
    stripped — the unit of traffic the serving router batches back up.
    Deterministic in (cfg, i); the last underlying batch is memoized."""

    def __init__(self, cfg: CtrDataConfig):
        self.cfg = cfg
        self._stream = CtrStream(cfg)
        self._step = -1
        self._batch: Optional[dict] = None

    def request_at(self, i: int) -> dict:
        step, row = divmod(int(i), self.cfg.batch_size)
        if step != self._step:
            self._step, self._batch = step, self._stream.batch_at(step)
        return {k: v[row] for k, v in self._batch.items() if k != "label"}

    def requests(self, n: int, start: int = 0) -> list:
        return [self.request_at(i) for i in range(start, start + n)]

    def id_batches(self, n_batches: int, start_step: int = 0) -> list:
        """[B, F] sparse-id arrays for ``n_batches`` consecutive steps —
        the cache-warming feed (``HotRowCache.warm``)."""
        return [self._stream.batch_at(s)["sparse"]
                for s in range(start_step, start_step + n_batches)]


def retrieval_batch(cfg: CtrDataConfig, step: int, n_user_fields: int,
                    n_candidates: int) -> dict:
    """One query + a candidate set for retrieval scoring: the first sample
    of ``batch_at(step)``'s sparse ids [1, F] and ``n_candidates`` uniform
    item-field ids [n_candidates, F - n_user_fields] (int32)."""
    stream = CtrStream(cfg)
    b = stream.batch_at(step)
    rs = np.random.RandomState((cfg.seed * 7 + step) % 2 ** 31)
    item_vocab = np.asarray(cfg.vocab_sizes[n_user_fields:], np.int64)
    cand = (rs.random_sample((n_candidates, len(item_vocab)))
            * item_vocab[None, :]).astype(np.int32)
    return {"sparse": b["sparse"][:1], "cand_sparse": cand}
