"""Driver ``bulk_score``: offline scoring in fixed batches.

The traffic file gives ``batch`` (samples a batch), ``pool`` (distinct
batches made at set-up from the seed and cycled through the window),
``check_units`` (batches of the window whose scores are checked, drawn
from the seed, the last one always among them) and ``trace_seconds``
(the traced window).  One batch is in flight: the entry returns its
scores on the host before the next is sent.  End to end:
``score_samples_per_s``, every sample scored over the time from the
window's start to the end of the last batch.
"""

from __future__ import annotations

from lib import stream
from lib.window import Window, pick, score_checks, score_window, warm


def inputs(cfg: dict, traffic: dict, seed: int) -> list:
    return [stream.batch_at(cfg["vocab_sizes"], cfg.get("n_dense", 0),
                            traffic["batch"], seed, k, labels=False)
            for k in range(traffic["pool"])]


prepare = warm
window = score_window


def end_to_end(win: Window) -> dict:
    return {"score_samples_per_s": (win.samples / win.elapsed, "samples/s")}


def checks(win: Window, pool: list, traffic: dict, seed: int, prep: dict,
           reference) -> dict:
    n = len(win.units)
    sample = pick(n, traffic["check_units"], seed, always=(n - 1,))
    return score_checks(win, pool, sample, reference.scores)
