"""Async request router: deadline-aware batching under a p99 budget
(PyTorch port of ``repro.serve.router``; pure host code, numpy and
asyncio, whose decisions are the JAX package's).

The serving tier's admission path.  Two layers, split so the policy is
deterministic-clock-testable (the same design as ``train.elastic``'s
``FaultClock`` harness):

* ``DeadlineBatcher`` — a pure batching state machine with NO clock of its
  own: every method takes ``now``.  It admits requests against a bounded
  queue and a per-request latency budget (a request whose deadline cannot
  be met even if dispatched immediately is shed at the door with a clear
  ``LoadShedError`` instead of blowing the p99 for everyone behind it),
  and closes batches adaptively: dispatch when the batch fills *or* when
  the tightest pending deadline minus the model's measured p50 service
  time nears.  ``FixedBatcher`` is the classic fill-or-timeout policy the
  replay harness benchmarks it against.
* ``AsyncRouter`` — the asyncio front-end: ``submit()`` parks a future per
  request, a single dispatcher task sleeps exactly until the policy's next
  ``close_at`` (or a new arrival wakes it), and each dispatched batch is
  stacked, padded to the fixed batch shape, scored, sliced, and routed
  back to its callers' futures.  The clock is injectable.

Score-fn contract (shared with ``MicroBatcher`` and the replay): the
callable receives the padded feature batch and may additionally accept an
``n_valid`` keyword naming how many leading rows are real — a stateful
consumer (the hot-row cache's frequency sketch) must never count the
padded tail.  Scores come back as an array whose leading axis is the
batch; only the first ``n_valid`` rows are delivered.
"""

from __future__ import annotations

import asyncio
import dataclasses
import inspect
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["LoadShedError", "RouterConfig", "PendingRequest",
           "DeadlineBatcher", "FixedBatcher", "AsyncRouter",
           "stack_and_pad", "accepts_n_valid"]


class LoadShedError(RuntimeError):
    """Admission rejected — queue full or deadline infeasible.

    Explicit load shedding: the caller gets a clear, immediate error (and
    can retry against another replica) instead of a silently blown p99.
    """

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        super().__init__(f"request shed ({reason})"
                         + (f": {detail}" if detail else ""))


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Knobs for the batching policy.

    * ``max_batch``      — the fixed batch shape; dispatch at this fill.
    * ``max_queue``      — bound on not-yet-dispatched requests; beyond it
      admissions shed (``reason="queue_full"``).
    * ``max_wait_s``     — close-out bound for requests without a deadline
      (and the only close-out ``FixedBatcher`` knows).
    * ``close_margin_s`` — safety margin subtracted on top of the service
      estimate when scheduling a deadline close-out.
    * ``init_service_s`` — service-time prior before any observation.
    * ``service_window`` — number of recent service times whose p50 is the
      running estimate (see ``DeadlineBatcher.service_estimate``).
    * ``shed_infeasible``— shed requests whose deadline is already closer
      than the estimated service time at admission.
    """

    max_batch: int
    max_queue: int = 256
    max_wait_s: float = 0.050
    close_margin_s: float = 0.0
    init_service_s: float = 2e-3
    service_window: int = 64
    shed_infeasible: bool = True


@dataclasses.dataclass
class PendingRequest:
    features: Dict[str, np.ndarray]
    arrival: float
    deadline: Optional[float]
    seq: int


class DeadlineBatcher:
    """Deadline-aware batch close-out as a pure state machine.

    All times are seconds on whatever clock the caller uses — the policy
    never reads one.  FIFO dispatch order; the close-out time is

        min(oldest.arrival + max_wait,
            min(pending deadlines) - p50_service - margin)

    so a batch ships early exactly when waiting longer would make its
    tightest request miss its deadline after the (measured) service time.
    """

    def __init__(self, cfg: RouterConfig):
        self.cfg = cfg
        self._pending: List[PendingRequest] = []
        self._seq = 0
        self._service: List[float] = []     # recent service times, unsorted
        self.shed_count = 0

    # -- admission ---------------------------------------------------------

    def admit(self, features: Dict[str, np.ndarray], now: float,
              deadline: Optional[float] = None) -> PendingRequest:
        """Admit one request or raise ``LoadShedError``."""
        if len(self._pending) >= self.cfg.max_queue:
            self.shed_count += 1
            raise LoadShedError("queue_full",
                                f"{len(self._pending)} pending >= "
                                f"max_queue {self.cfg.max_queue}")
        if (deadline is not None and self.cfg.shed_infeasible
                and now + self.service_estimate
                + self.cfg.close_margin_s > deadline):
            self.shed_count += 1
            raise LoadShedError(
                "infeasible_deadline",
                f"deadline in {(deadline - now) * 1e3:.2f}ms < estimated "
                f"service {self.service_estimate * 1e3:.2f}ms")
        req = PendingRequest(features=features, arrival=now,
                             deadline=deadline, seq=self._seq)
        self._seq += 1
        self._pending.append(req)
        return req

    # -- close-out ---------------------------------------------------------

    def close_at(self) -> Optional[float]:
        """Earliest time the current batch must dispatch (None: no work).

        The deadline term ranges over only the first ``max_batch`` pending
        requests — the FIFO prefix ``poll`` will actually ship.  A tight
        deadline parked deeper in the queue cannot ride this batch, so
        letting it force a premature close-out would shrink the batch
        without helping the tight request at all (it drives the close-out
        once it reaches the head of the queue).
        """
        if not self._pending:
            return None
        t = self._pending[0].arrival + self.cfg.max_wait_s
        deadlines = [r.deadline for r in self._pending[:self.cfg.max_batch]
                     if r.deadline is not None]
        if deadlines:
            t = min(t, min(deadlines) - self.service_estimate
                    - self.cfg.close_margin_s)
        return t

    def poll(self, now: float) -> Optional[List[PendingRequest]]:
        """Return the next batch to dispatch, or None if none is due."""
        if not self._pending:
            return None
        if len(self._pending) < self.cfg.max_batch and now < self.close_at():
            return None
        batch = self._pending[:self.cfg.max_batch]
        self._pending = self._pending[self.cfg.max_batch:]
        return batch

    def drain(self) -> List[List[PendingRequest]]:
        """All remaining requests, chunked — shutdown / sync flush."""
        out = []
        while self._pending:
            out.append(self._pending[:self.cfg.max_batch])
            self._pending = self._pending[self.cfg.max_batch:]
        return out

    # -- service-time feedback --------------------------------------------

    def observe(self, service_s: float) -> None:
        """Record one measured batch service time (drives close-out)."""
        self._service.append(float(service_s))
        if len(self._service) > self.cfg.service_window:
            self._service = self._service[-self.cfg.service_window:]

    @property
    def service_estimate(self) -> float:
        """p50 of the recent service times (prior before observations)."""
        if not self._service:
            return self.cfg.init_service_s
        s = sorted(self._service)
        return s[max(0, -(-len(s) // 2) - 1)]      # nearest-rank p50

    def __len__(self) -> int:
        return len(self._pending)


class FixedBatcher(DeadlineBatcher):
    """The baseline policy: dispatch only when full (or at ``max_wait_s``,
    the safety valve) — deadlines are carried but never consulted, so the
    tail of a partially-filled batch eats the whole wait.  Exists to give
    the replay harness an honest fixed-size comparison point."""

    def __init__(self, cfg: RouterConfig):
        super().__init__(dataclasses.replace(cfg, shed_infeasible=False))

    def close_at(self) -> Optional[float]:
        if not self._pending:
            return None
        return self._pending[0].arrival + self.cfg.max_wait_s


# ---------------------------------------------------------------------------
# batch assembly
# ---------------------------------------------------------------------------

def stack_and_pad(features: Sequence[Dict[str, np.ndarray]],
                  batch_size: int) -> tuple:
    """Stack per-request feature dicts into one padded batch.

    Returns ``(batch, n_valid)``: each key stacked on a new leading axis
    and padded to ``batch_size`` by repeating the last real row (the
    batch shape never changes); ``n_valid`` is how many leading rows
    are real.  Consumers must treat rows ``>= n_valid`` as padding.
    """
    if not features:
        raise ValueError("stack_and_pad: empty batch")
    n = len(features)
    if n > batch_size:
        raise ValueError(f"{n} requests > batch_size {batch_size}")
    keys = list(features[0])
    key_set = set(keys)
    for j, f in enumerate(features[1:], start=1):
        # extra keys would be dropped silently and missing ones would
        # surface as a bare KeyError mid-np.stack — same clear contract
        # MicroBatcher.submit promises at its door
        if set(f) != key_set:
            raise ValueError(
                f"stack_and_pad: request {j} keys {sorted(f)} != the "
                f"batch's keys {sorted(key_set)}; all requests in a batch "
                f"must share the same feature keys")
    batch = {k: np.stack([np.asarray(f[k]) for f in features])
             for k in keys}
    if n < batch_size:
        pad = batch_size - n
        batch = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                 for k, v in batch.items()}
    return batch, n


def accepts_n_valid(fn: Callable) -> bool:
    """True when ``fn`` can take the ``n_valid`` keyword (see module doc)."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False
    return "n_valid" in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


# ---------------------------------------------------------------------------
# the asyncio front-end
# ---------------------------------------------------------------------------

class AsyncRouter:
    """Async admission + dispatch around a ``DeadlineBatcher``.

    ``submit()`` admits (raising ``LoadShedError`` on shed), parks a
    future, and wakes the dispatcher; the dispatcher sleeps exactly until
    the policy's next forced close (or a wake), dispatches every due
    batch, and resolves the batch's futures with per-request score rows.
    Scoring runs inline on the event loop — the scorer is one call at a
    fixed shape (a deployment fronting several devices would move it to an
    executor; one resident model gains nothing from that).

    ``clock`` is injectable for tests / latency accounting; the dispatcher
    converts policy close-out times to relative waits with it.
    """

    def __init__(self, score_fn: Callable, batcher: DeadlineBatcher, *,
                 clock: Callable[[], float] = time.monotonic):
        self._score_fn = score_fn
        self._pass_valid = accepts_n_valid(score_fn)
        self._batcher = batcher
        self._clock = clock
        self._futures: Dict[int, asyncio.Future] = {}
        self._wake: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._stopping = False
        self.dispatched_batches = 0

    @property
    def batcher(self) -> DeadlineBatcher:
        return self._batcher

    async def start(self) -> None:
        self._wake = asyncio.Event()
        self._stopping = False
        self._task = asyncio.create_task(self._run())

    async def stop(self, flush: bool = True) -> None:
        """Stop the dispatcher; ``flush`` scores everything still queued."""
        self._stopping = True
        if self._wake is not None:
            self._wake.set()
        if self._task is not None:
            await self._task
            self._task = None
        if flush:
            for reqs in self._batcher.drain():
                self._dispatch(reqs)

    async def submit(self, features: Dict[str, np.ndarray],
                     budget_s: Optional[float] = None) -> np.ndarray:
        """Score one request; resolves when its batch is served.

        ``budget_s`` is the per-request latency budget: the deadline is
        ``now + budget_s`` and drives both admission (an infeasible budget
        sheds immediately) and the adaptive close-out.
        """
        if self._task is None:
            raise RuntimeError("router not started (await router.start())")
        now = self._clock()
        deadline = None if budget_s is None else now + budget_s
        req = self._batcher.admit(features, now, deadline=deadline)
        fut = asyncio.get_running_loop().create_future()
        self._futures[req.seq] = fut
        self._wake.set()
        return await fut

    async def apply(self, fn: Callable):
        """Run ``fn`` strictly *between* dispatched micro-batches — the
        hot-swap barrier ``EmbeddingServer.push`` rides through.

        ``_dispatch`` is synchronous on the event loop, so a coroutine step
        (this call) can never interleave with a batch mid-score: every
        request dispatched before ``apply`` resolves on the old model, the
        next dispatched batch sees whatever ``fn`` installed, and no batch
        ever scores on mixed params.  Requests already admitted to the
        queue are untouched — they dispatch normally afterwards (on the
        new model), never shed.  Returns ``fn()``'s result.
        """
        if self._task is None:
            raise RuntimeError("router not started (await router.start())")
        result = fn()
        # service estimates may shift with new params; wake the dispatcher
        # so close-outs are re-planned rather than slept through
        self._wake.set()
        return result

    async def _run(self) -> None:
        while not self._stopping:
            now = self._clock()
            reqs = self._batcher.poll(now)
            if reqs is not None:
                self._dispatch(reqs)
                continue
            t = self._batcher.close_at()
            timeout = None if t is None else max(0.0, t - now)
            try:
                await asyncio.wait_for(self._wake.wait(), timeout)
            except asyncio.TimeoutError:
                pass
            self._wake.clear()

    def _dispatch(self, reqs: List[PendingRequest]) -> None:
        batch, n_valid = stack_and_pad(
            [r.features for r in reqs], self._batcher.cfg.max_batch)
        t0 = self._clock()
        if self._pass_valid:
            scores = np.asarray(self._score_fn(batch, n_valid=n_valid))
        else:
            scores = np.asarray(self._score_fn(batch))
        self._batcher.observe(self._clock() - t0)
        self.dispatched_batches += 1
        for i, r in enumerate(reqs):
            fut = self._futures.pop(r.seq, None)
            if fut is not None and not fut.done():
                fut.set_result(scores[i])
