"""Serving utilities: sync micro-batching front-end + latency profiling
(PyTorch port of ``repro.serve.serving``).

The serving subsystem proper lives in the sibling modules — ``router``
(deadline-aware async batching), ``hot_cache`` (frequency-sketch hot-row
cache), ``server`` (multi-substrate ``EmbeddingServer``), ``replay``
(virtual-clock traffic replay).  This module keeps the synchronous
conveniences:

* ``MicroBatcher`` — a thin sync wrapper over the router's
  ``DeadlineBatcher`` policy: same admission checks, same close-out
  logic (``poll()`` dispatches only batches that are due; ``flush()``
  force-closes everything), one shared padding path
  (``router.stack_and_pad``), so sync and async serving can never drift.
  The scorer receives the padded batch as numpy arrays; the server moves
  it to its device.
* ``latency_profile`` — steady-state percentiles of a scoring function,
  the first call reported separately.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.serve.router import (DeadlineBatcher, RouterConfig,
                                      accepts_n_valid, stack_and_pad)
from repro_torch.tree import leaves

__all__ = ["MicroBatcher", "latency_profile", "percentile"]


def percentile(sorted_values, p: float) -> float:
    """Nearest-rank percentile of an ascending-sorted sequence.

    Rank is ``ceil(p·n)`` (1-indexed), i.e. index ``ceil(p·n) − 1`` — the
    smallest value with at least a ``p`` fraction of the sample at or
    below it.
    """
    n = len(sorted_values)
    if n == 0:
        raise ValueError("percentile of an empty sample")
    if not 0.0 < p <= 1.0:
        raise ValueError(f"p must be in (0, 1], got {p}")
    return float(sorted_values[max(0, math.ceil(p * n) - 1)])


class MicroBatcher:
    """Collects requests into fixed-size batches (padding the tail) so the
    scoring function always sees one shape; ``max_wait_ms`` bounds p99.

    Sync front-end over the router's ``DeadlineBatcher``: ``submit``
    admits (raising the policy's ``LoadShedError`` when the queue bound
    trips), ``poll()`` dispatches only the batches the close-out logic
    says are due, ``flush()`` force-closes everything.  The padded tail
    repeats the last real row, and the real row count is threaded
    through: ``flush``/``poll`` slice the scores back to real requests
    before returning them, and a ``score_fn`` that accepts the ``n_valid``
    keyword is told how many leading rows are real — so no consumer,
    stateless or stateful, can mistake padded scores for real ones.
    """

    def __init__(self, batch_size: int, score_fn: Callable[..., np.ndarray],
                 max_wait_ms: float = 2.0, max_queue: int = 4096,
                 clock: Callable[[], float] = time.monotonic):
        self.batch_size = batch_size
        self.score_fn = score_fn
        self._pass_valid = accepts_n_valid(score_fn)
        self._clock = clock
        self._batcher = DeadlineBatcher(RouterConfig(
            max_batch=batch_size, max_queue=max_queue,
            max_wait_s=max_wait_ms / 1e3))

    def __len__(self) -> int:
        return len(self._batcher)

    def submit(self, request: Dict[str, np.ndarray]) -> None:
        # reject at the door (a clear error naming the keys), not as a
        # KeyError deep in np.stack — and without poisoning the queue:
        # already-accepted requests stay servable
        if len(self._batcher):
            have = set(self._batcher._pending[0].features)
            if set(request) != have:
                raise ValueError(
                    f"MicroBatcher: request keys {sorted(request)} != the "
                    f"queued batch's keys {sorted(have)}; all requests in "
                    f"a batch must share the same feature keys")
        self._batcher.admit(request, self._clock())

    def _score(self, reqs) -> List[np.ndarray]:
        batch, n = stack_and_pad([r.features for r in reqs],
                                 self.batch_size)
        if self._pass_valid:
            scores = np.asarray(self.score_fn(batch, n_valid=n))
        else:
            scores = np.asarray(self.score_fn(batch))
        return list(scores[:n])          # padded tail never escapes

    def poll(self, now: Optional[float] = None) -> List[np.ndarray]:
        """Score only the batches that are due (full, or past the
        close-out the deadline logic computed); [] when none is."""
        now = self._clock() if now is None else now
        out: List[np.ndarray] = []
        while True:
            reqs = self._batcher.poll(now)
            if reqs is None:
                return out
            out.extend(self._score(reqs))

    def flush(self) -> List[np.ndarray]:
        """Force-close everything queued; per-request scores in order."""
        out: List[np.ndarray] = []
        for reqs in self._batcher.drain():
            out.extend(self._score(reqs))
        return out


def _wait(r) -> None:
    """Block until ``r``'s first leaf is computed: ``torch.cuda.synchronize``
    on its device when it is a CUDA tensor (the JAX package's
    ``block_until_ready``)."""
    leaf = leaves(r)[0]
    if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)


def latency_profile(fn: Callable, batch: dict, iters: int = 32,
                    warmup: int = 1) -> dict:
    """Steady-state p50/p95/p99 wall latency of a scoring function.

    The first call is timed separately and reported as ``compile_ms`` (the
    JAX package's key: there it includes trace and compile; here it holds
    the first launch and any kernel build), and ``warmup`` further
    iterations are discarded (allocator churn), so the percentiles
    describe only the steady state a serving deployment actually sees.
    ``batch``'s arrays are handed to ``fn`` as tensors.  Percentiles are
    nearest-rank (see ``percentile``).
    """
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    t0 = time.monotonic()
    _wait(fn(tb))
    compile_ms = (time.monotonic() - t0) * 1e3
    for _ in range(warmup):                      # discarded warm-up iters
        _wait(fn(tb))
    lats = []
    for _ in range(iters):
        t0 = time.monotonic()
        _wait(fn(tb))
        lats.append((time.monotonic() - t0) * 1e3)
    lats = np.sort(np.asarray(lats))
    return {"p50_ms": percentile(lats, 0.5), "p95_ms": percentile(lats, 0.95),
            "p99_ms": percentile(lats, 0.99), "compile_ms": compile_ms}
