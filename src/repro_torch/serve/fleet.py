"""Multi-replica serving fleet: N ``EmbeddingServer``s, one admission path
(PyTorch port of ``repro.serve.fleet``).

``ReplicaFleet`` fronts N ``EmbeddingServer`` replicas built from the
**same** ``ServerConfig`` with **independent** parameter and hot-cache
state, behind one fleet contract:

* **Admission (retry-on-replica).**  A request joins the least-loaded
  replica's queue (fewest pending, then soonest-free, then index); a
  replica that sheds it (``LoadShedError``) retries on the next in that
  order.  The shed is terminal — re-raised with
  ``reason="all_replicas_shed"`` — only when *every* replica sheds.
* **Dispatch.**  Each replica drains its own queue onto its own busy
  timeline; the replay harness (``serve.replay`` with ``n_replicas``)
  models exactly this on one virtual clock.
* **Staggered rollout.**  ``push_all`` swaps replicas strictly one at a
  time (each swap is the per-replica ``EmbeddingServer.push`` barrier —
  drained between micro-batches, never mid-batch), so at any instant
  N−1 replicas keep serving on some consistent model.  ``rollout_event``
  packages the same rollout for the replay's virtual clock, where the
  one-at-a-time property is structural (swap k+1 starts at swap k's
  measured end); ``synchronized_events`` is the control that swaps every
  replica at the same instant.

Replica parameters start **identical**: replicas 1..N−1 share replica
0's init tensors, which is both the deployment story (replicas of one
trained model) and what makes fleet-vs-single-server score parity exact.
Sharing is safe because nothing writes into a served tensor: a push
rebinds one replica's parameter tree to fresh tensors — independence is
by rebinding, not by copying.  All replicas live on one device.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.router import LoadShedError
from repro_torch.serve.server import EmbeddingServer, PushReport, ServerConfig

__all__ = ["ReplicaFleet"]


class ReplicaFleet:
    """N ``EmbeddingServer`` replicas behind one admission path.

    ``fleet.replicas[r]`` is a full ``EmbeddingServer`` — per-replica
    params and hot caches — so anything that works on a
    single server (push, cache warm, ``score_fn``) works per replica;
    the fleet adds the cross-replica contract on top.
    """

    def __init__(self, cfg: ServerConfig, n_replicas: int = 2,
                 params: Optional[dict] = None, device=None):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        base = EmbeddingServer(cfg, params=params, device=device)
        self.cfg = cfg
        self.replicas: List[EmbeddingServer] = [base]
        for _ in range(n_replicas - 1):
            # share base's init tensors: identical scores by construction,
            # independent state by rebinding on push
            self.replicas.append(EmbeddingServer(
                cfg, params={b: base.params(b) for b in cfg.backends},
                device=base.device))
        self._dispatched = [0] * n_replicas

    def __len__(self) -> int:
        return len(self.replicas)

    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    @property
    def backends(self) -> Tuple[str, ...]:
        return tuple(self.cfg.backends)

    # -- admission (retry-on-replica) ---------------------------------------

    def admission_order(self, batchers: Sequence,
                        free: Optional[Sequence[float]] = None) -> List[int]:
        """Replica indices, least-loaded first.

        Load is (pending queue length, busy-until time, index) — the
        replica with the shortest queue wins, ties to the one free
        soonest, ties to the lowest index (deterministic).
        """
        if len(batchers) != len(self.replicas):
            raise ValueError(f"{len(batchers)} batchers != "
                             f"{len(self.replicas)} replicas")
        free = list(free) if free is not None else [0.0] * len(batchers)
        return sorted(range(len(batchers)),
                      key=lambda r: (len(batchers[r]), free[r], r))

    def admit(self, batchers: Sequence, features, now: float,
              deadline: Optional[float] = None,
              free: Optional[Sequence[float]] = None) -> int:
        """The one admission path: try replicas least-loaded first, a
        shed retries on the next, and ``LoadShedError`` is terminal only
        when every replica sheds.  Returns the admitting replica index.

        ``batchers``: one ``DeadlineBatcher`` per replica (the caller
        owns them — the replay harness, or an ``AsyncRouter`` each).
        """
        last: Optional[LoadShedError] = None
        for r in self.admission_order(batchers, free):
            try:
                batchers[r].admit(features, now, deadline=deadline)
                return r
            except LoadShedError as e:
                last = e
        raise LoadShedError(
            "all_replicas_shed",
            f"every one of {len(self.replicas)} replicas shed "
            f"(last: {last.reason if last is not None else 'n/a'})")

    # -- scoring ------------------------------------------------------------

    def score(self, backend: str, batch, n_valid: Optional[int] = None, *,
              replica: Optional[int] = None,
              use_cache: bool = True) -> np.ndarray:
        """Score one padded batch on the least-dispatched replica (or an
        explicit one).  Any replica returns the same scores until pushes
        diverge them — parity the fleet tests assert exactly."""
        if replica is None:
            replica = min(range(len(self.replicas)),
                          key=lambda r: (self._dispatched[r], r))
        self._dispatched[replica] += 1
        return self.replicas[replica].score(backend, batch, n_valid,
                                            use_cache=use_cache)

    def score_fns(self, backend: str, *,
                  use_cache: bool = True) -> List[Callable]:
        """One ``score_fn(batch, n_valid=...)`` per replica, in order —
        the replay harness's per-replica ``services`` feed."""
        return [rep.score_fn(backend, use_cache=use_cache)
                for rep in self.replicas]

    # -- staggered rollout ---------------------------------------------------

    def push_all(self, backend: str, step: Optional[int] = None, *,
                 ckpt_dir: Optional[str] = None) -> Tuple[PushReport, ...]:
        """Staggered rollout of one publish across the fleet.

        Replicas swap strictly one at a time — this method is synchronous,
        so the one-at-a-time property is structural — and each swap is the
        per-replica ``EmbeddingServer.push`` barrier (atomic between
        micro-batches, queued requests untouched).  While replica r is
        mid-swap the other N−1 keep serving: r−1.. on the new model,
        r+1.. on the old — each on *some* consistent model, never a mix.
        Returns the per-replica ``PushReport``s in rollout order.
        """
        return tuple(rep.push(backend, step=step, ckpt_dir=ckpt_dir)
                     for rep in self.replicas)

    def rollout_event(self, t: float, backend: str,
                      step: Optional[int] = None, *,
                      ckpt_dir: Optional[str] = None) -> tuple:
        """The staggered rollout as one replay event:
        ``(t, [(replica, push_fn), ...])``.  The replay drains each
        replica before its swap — it leaves admission rotation, its
        queue empties, *then* the swap fires, and the next replica's
        drain starts at this swap's measured end.  At most one replica
        is ever mid-rollout and no admitted request waits out a swap —
        the fleet-p99-friendly policy."""
        return (float(t),
                [(r, lambda rep=rep: rep.push(backend, step=step,
                                              ckpt_dir=ckpt_dir))
                 for r, rep in enumerate(self.replicas)])

    def synchronized_events(self, t: float, backend: str,
                            step: Optional[int] = None, *,
                            ckpt_dir: Optional[str] = None) -> List[tuple]:
        """The control policy: every replica swaps at the same virtual
        instant — ``[(t, push_fn, replica), ...]`` replay events.  The
        whole fleet is briefly down together, which is exactly the p99
        spike the staggered rollout exists to avoid."""
        return [(float(t),
                 (lambda rep=rep: rep.push(backend, step=step,
                                           ckpt_dir=ckpt_dir)), r)
                for r, rep in enumerate(self.replicas)]

    def pushed_steps(self, backend: str) -> List[Optional[int]]:
        """Per-replica last applied publish step (None: init params)."""
        return [rep.pushed_step(backend) for rep in self.replicas]

    # -- cache bookkeeping ---------------------------------------------------

    def warm_caches(self, id_batches: Sequence[np.ndarray]) -> None:
        """Warm every replica's caches on the same prior-traffic window
        (each replica keeps its own independent heat thereafter)."""
        for rep in self.replicas:
            rep.warm_caches(id_batches)

    def reset_caches(self) -> None:
        for rep in self.replicas:
            rep.reset_caches()

    def reset_cache_stats(self) -> None:
        for rep in self.replicas:
            rep.reset_cache_stats()

    def cache_stats(self, backend: str) -> List[Optional[dict]]:
        """Per-replica cache stats (None where the substrate declines)."""
        return [rep.cache_stats(backend) for rep in self.replicas]
