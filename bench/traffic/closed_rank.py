"""Driver ``closed_rank``: online ranking, a closed loop with one request
in flight.

A request holds one user's candidates.  The traffic file gives the
sizes' law: ``requests`` sizes at the quantiles of a log-uniform law over
[``min_candidates``, ``max_candidates``], the same set for every seed;
the seed draws their order and the candidates' ids (the requests are
consecutive slices of one batch of the stream).  The pool is cycled through the window.  ``check_requests``
requests of the window, drawn from the seed with the largest among them,
are checked.  End to end: ``request_p95_ms``, the 95th percentile of the
latency of every request completed in the window, each timed from its
send to its scores on the host.
"""

from __future__ import annotations

import numpy as np

from lib import stream
from lib.window import Window, pick, score_checks, score_window, warm


def sizes(traffic: dict) -> np.ndarray:
    n, lo, hi = (traffic["requests"], traffic["min_candidates"],
                 traffic["max_candidates"])
    q = (np.arange(n) + 0.5) / n
    return np.round(lo * (hi / lo) ** q).astype(np.int64)


def inputs(cfg: dict, traffic: dict, seed: int) -> list:
    """The requests: one batch of the stream, cut in the seed's order of
    the sizes."""
    order = np.random.RandomState(seed % 2 ** 31).permutation(
        sizes(traffic))
    whole = stream.batch_at(cfg["vocab_sizes"], cfg.get("n_dense", 0),
                            int(order.sum()), seed, 0, labels=False)
    cuts = np.cumsum(order)[:-1]
    parts = {k: np.split(v, cuts) for k, v in whole.items()}
    return [{k: parts[k][i] for k in parts} for i in range(len(order))]


prepare = warm
window = score_window


def end_to_end(win: Window) -> dict:
    return {"request_p95_ms": (float(np.percentile(win.latencies, 95)) * 1e3,
                               "ms")}


def checks(win: Window, pool: list, traffic: dict, seed: int, prep: dict,
           reference) -> dict:
    largest = int(np.argmax(win.sizes))
    sample = pick(len(win.units), traffic["check_requests"], seed,
                  always=(largest,))
    return score_checks(win, pool, sample, reference.scores)
