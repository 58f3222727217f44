"""Synthetic LM token stream with learnable n-gram structure (numpy; a
copy of ``repro.data.lm_data`` whose draws match it call for call).

Tokens follow a noisy affine recurrence ``t_{i+1} ≈ (a·t_i + c) mod V``
with 10% uniform noise, enough structure for the CE loss to drop in a few
hundred steps.  Deterministic per (seed, step) for resume.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LmDataConfig:
    vocab: int
    seq_len: int
    batch_size: int
    seed: int = 99


class LmStream:
    def __init__(self, cfg: LmDataConfig):
        self.cfg = cfg
        rs = np.random.RandomState(cfg.seed)
        self.a = int(rs.randint(3, 97) * 2 + 1)
        self.c = int(rs.randint(1, cfg.vocab))

    def batch_at(self, step: int) -> dict:
        """{"tokens", "labels"} int32 [B, T]: labels are tokens shifted by
        one."""
        cfg = self.cfg
        rs = np.random.RandomState((cfg.seed * 611953 + step) % 2 ** 31)
        b, t, v = cfg.batch_size, cfg.seq_len, cfg.vocab
        toks = np.empty((b, t + 1), np.int64)
        toks[:, 0] = rs.randint(0, v, b)
        noise = rs.random_sample((b, t)) < 0.1
        rand = rs.randint(0, v, (b, t))
        for i in range(t):
            nxt = (self.a * toks[:, i] + self.c) % v
            toks[:, i + 1] = np.where(noise[:, i], rand[:, i], nxt)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}
