"""The benchmark's input stream: zipf ids, dense features and labels.

A frozen copy of ``CtrStream.batch_at`` and ``_field_value_score`` from
``src/repro_torch/data/synthetic_ctr.py`` at commit aa881b5 (drift off,
single-hot), so that a later change to the program's data layer cannot
move the yardstick.  ``tests/test_harness_yardstick.py`` holds it to the
program's stream for the same seed.  Only ``labels=False`` is new: it
skips the label draw, which comes last, so the ids and dense features
are those of the full batch.
"""

from __future__ import annotations

import numpy as np


def field_value_score(field: np.ndarray, value: np.ndarray,
                      seed: int) -> np.ndarray:
    """Deterministic pseudo-random score in [-1, 1] per (field, value)."""
    with np.errstate(over="ignore"):           # uint64 wraparound intended
        h = (value.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
             + field.astype(np.uint64) * np.uint64(0xBF58476D1CE4E5B9)
             + np.uint64(seed % 2**32) * np.uint64(0x94D049BB133111EB))
        h ^= h >> np.uint64(29)
        h *= np.uint64(0xBF58476D1CE4E5B9)
        h ^= h >> np.uint64(32)
    return (h.astype(np.float64) / 2 ** 64) * 2.0 - 1.0


def sample_ids(rs: np.random.RandomState, vocab: np.ndarray, n: int,
               zipf_exponent: float) -> np.ndarray:
    """[n, F] power-law ids per field, by inverse CDF on u^(1/alpha)."""
    u = rs.random_sample((n, len(vocab)))
    skew = u ** (1.0 / max(1e-6, zipf_exponent)) \
        if zipf_exponent != 1.0 else u
    ids = (skew * skew * vocab[None, :]).astype(np.int64)
    return np.minimum(ids, vocab[None, :] - 1)


def batch_at(vocab_sizes, n_dense: int, batch_size: int, seed: int,
             step: int, *, zipf_exponent: float = 1.05,
             label_temperature: float = 1.2, labels: bool = True) -> dict:
    """Batch ``step`` of the stream seeded ``seed``: ``sparse`` [B, F]
    int32, ``dense`` [B, n_dense] f32 (when n_dense > 0) and ``label`` [B]
    int32 (when ``labels``), all numpy."""
    vocab = np.asarray(vocab_sizes, np.int64)
    rs = np.random.RandomState((seed * 1_000_003 + step) % 2 ** 31)
    ids = sample_ids(rs, vocab, batch_size, zipf_exponent)
    batch = {}
    if labels:
        fields = np.arange(len(vocab), dtype=np.int64)
        score = field_value_score(np.broadcast_to(fields[None, :], ids.shape),
                                  ids, seed).mean(axis=1) * 4.0
    if n_dense:
        dense = rs.randn(batch_size, n_dense).astype(np.float32)
        batch["dense"] = dense
        if labels:
            score = score + 0.3 * dense[:, :min(4, n_dense)].mean(axis=1)
    if labels:
        prob = 1.0 / (1.0 + np.exp(-score / label_temperature))
        batch["label"] = (rs.random_sample(batch_size) < prob).astype(
            np.int32)
    batch["sparse"] = ids.astype(np.int32)
    return batch
