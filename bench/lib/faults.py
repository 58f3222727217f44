"""Faults planted under the timed path, for the tests and the readings that
show the output check fails them.  Each wraps an entry; none is reachable
from the benchmark's command line but through ``--fault``.

* ``unchanged``: the train step returns its state as it was;
* ``half_batch``: the program gets the first half of each batch (the
  mean loss taken over the rest; a scorer answers half the candidates);
* ``alter``: one score of each batch is moved by the batch's root mean
  square, where the program produced it.
"""

from __future__ import annotations

import numpy as np

FAULTS = ("unchanged", "half_batch", "alter")


def _half(batch: dict) -> dict:
    """The first half of every array of a unit, along its leading axis."""
    return {k: v[:v.shape[0] // 2] for k, v in batch.items()}


class Faulty:
    def __init__(self, entry, fault: str):
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.entry, self.fault = entry, fault

    def score(self, batch):
        if self.fault == "half_batch":
            return self.entry.score(_half(batch))
        out = self.entry.score(batch)
        if self.fault == "alter":
            out = out.copy()
            out[len(out) // 3] += np.sqrt(np.mean(out.astype(np.float64)
                                                  ** 2))
        return out

    def step(self, batch):
        if self.fault == "half_batch":
            return self.entry.step(_half(batch))
        if self.fault == "unchanged":
            state = self.entry.state
            metrics = self.entry.step(batch)
            self.entry.state = state
            return metrics
        return self.entry.step(batch)

    def params(self):
        return self.entry.params()
