"""What a measured window leaves behind, and what the score cells'
drivers share: their warm-up, their window and their check."""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Window:
    units: list                  # pool index of each unit, in order
    sizes: list                  # samples of each unit
    elapsed: float               # window start to the end of the last unit
    outputs: Optional[list] = None        # scores of each unit (score cells)
    latencies: Optional[list] = None      # seconds of each unit (requests)
    enqueue: Optional[list] = None        # host seconds to issue each step
    failed: int = 0

    @property
    def samples(self) -> int:
        return int(sum(self.sizes))


def pick(n: int, k: int, seed: int, always=()) -> list:
    """``k`` distinct indices of ``range(n)`` drawn from the seed, with
    ``always`` among them."""
    rs = np.random.RandomState((seed * 7 + 0x5EED) % 2 ** 31)
    chosen = set(int(a) for a in always)
    order = rs.permutation(n)
    for i in order:
        if len(chosen) >= min(k, n):
            break
        chosen.add(int(i))
    return sorted(chosen)


def score_checks(win: Window, pool: list, sample: list, reference) -> dict:
    """``score_gap``: the widest gap between a sampled unit's scores and
    the reference's over the same inputs, as a share of the root mean
    square of the reference's scores (the worst unit); ``failed``: units
    whose output has the wrong length or a value that is not finite."""
    failed = 0
    for i, out in zip(win.units, win.outputs):
        n = pool[i]["sparse"].shape[0]
        if out is None or out.shape != (n,) or not np.all(np.isfinite(out)):
            failed += 1
    gap, cache = 0.0, {}
    for j in sample:
        i = win.units[j]
        if i not in cache:
            cache[i] = reference(pool[i])
        ref, out = cache[i], win.outputs[j]
        if out is None or out.shape != ref.shape:
            gap = float("inf")
            continue
        rms = float(np.sqrt(np.mean(ref.astype(np.float64) ** 2)))
        g = float(np.max(np.abs(out.astype(np.float64) - ref))) / rms
        gap = max(gap, g if np.isfinite(g) else float("inf"))
    return {"score_gap": gap, "failed": failed}


def warm(entry, pool: list, traffic: dict) -> dict:
    """Score every input of the pool once: the cell's own shapes."""
    for batch in pool:
        entry.score(batch)
    return {}


def score_window(entry, pool: list, seconds: float, span, prep: dict
                 ) -> Window:
    """Score the pool's inputs in turn, one in flight, each timed from its
    send to its scores on the host, until ``seconds`` have passed."""
    units, sizes, outs, lat = [], [], [], []
    t0 = time.perf_counter()
    with span("bench.window"):
        while True:
            i = len(units) % len(pool)
            ts = time.perf_counter()
            with span("bench.unit"):
                out = entry.score(pool[i])
            t = time.perf_counter()
            units.append(i)
            sizes.append(pool[i]["sparse"].shape[0])
            outs.append(out)
            lat.append(t - ts)
            if t - t0 >= seconds:
                break
    return Window(units=units, sizes=sizes, elapsed=t - t0, outputs=outs,
                  latencies=lat)
