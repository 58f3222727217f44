"""Skewed traffic replay: open-loop Poisson load against the serving tier
(PyTorch port of ``repro.serve.replay``).

Replay a deterministic synthetic-CTR request trace (``data.synthetic_ctr``:
zipf-skewed ids, Poisson arrivals) through a batching policy
(``router.DeadlineBatcher`` vs ``router.FixedBatcher``) into a substrate
of the ``EmbeddingServer``, and record p50/p99 latency, delivered
throughput, shed counts, and hot-cache hit rate per backend × policy ×
zipf cell.

The replay runs on a **virtual clock** — the event loop advances time to
the next arrival or forced batch close-out; nothing ever sleeps:

* queueing/waiting time is simulated exactly (deterministic given the
  trace and a service model), so tests assert on latency distributions
  to the float with ``synthetic_service``;
* with ``measured_service`` each dispatched batch really executes the
  scorer and its wall time, stamped once the scores are on the host,
  becomes the batch's service time on the virtual timeline — real
  compute, simulated waiting.

Single-server semantics: dispatched batches execute in order on one
model; a batch closed while the scorer is busy queues for the device.
Open-loop arrivals never back off, so overload shows up as shed requests
and rising p99 — the behaviour a p99 budget is supposed to bound.

Fleet semantics (``n_replicas > 1``): each replica owns a batcher and a
busy timeline on the *same* virtual clock.  Admission is the fleet
contract (``serve.fleet.ReplicaFleet``): a new request joins the
least-loaded replica's queue, a replica that sheds it retries on the
next, and ``LoadShedError`` is terminal only when every replica sheds.
Push events carry a replica index — or, for a staggered rollout, a
sequence of per-replica swaps serialized on their measured end times, so
at most one replica is ever mid-swap on the virtual timeline while the
rest keep serving.

This module returns plain row dicts.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.data.synthetic_ctr import (CtrDataConfig, RequestStream,
                                      poisson_arrivals)
from repro_torch.serve.router import (DeadlineBatcher, FixedBatcher,
                                LoadShedError, RouterConfig, accepts_n_valid,
                                stack_and_pad)
from repro_torch.serve.serving import percentile

__all__ = ["ReplayConfig", "ReplayReport", "replay", "synthetic_service",
           "measured_service", "make_batcher", "run_cell", "run_grid",
           "run_push_cell", "run_fleet_cell", "run_fleet_push_cell"]


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    """One replay cell: a trace plus a batching policy."""

    n_requests: int = 2048
    rate_hz: float = 2000.0            # offered load (open-loop)
    deadline_s: Optional[float] = 0.025   # per-request budget (None: none)
    policy: str = "deadline"           # "deadline" | "fixed"
    max_batch: int = 32
    max_queue: int = 256
    max_wait_s: float = 0.050          # fixed policy's only close-out
    init_service_s: float = 2e-3
    seed: int = 0


@dataclasses.dataclass
class ReplayReport:
    p50_ms: float
    p95_ms: float
    p99_ms: float
    qps: float                         # delivered (completed / makespan)
    offered_qps: float
    completed: int
    shed: int
    batches: int
    mean_batch: float
    makespan_s: float
    deadline_miss: int                 # completed but past their deadline
    # -- model-push metrics (populated only when replay ran with events) --
    has_pushes: bool = False
    pushes: int = 0                    # push events fired on the timeline
    push_p50_ms: float = 0.0           # wall time of the push itself
    push_max_ms: float = 0.0
    mean_staleness_s: float = 0.0      # mean over completed requests of
    #   (batch completion − last push before its dispatch): how old the
    #   model a request was scored on is, under this push schedule
    # -- fleet diagnostics (never serialized into rows; the fleet cell
    #    runners lift what they want into explicit columns) --
    n_replicas: int = 1
    retried: int = 0                   # admissions delivered by a later
    #   replica after an earlier one shed (retry-on-replica successes)
    replica_batches: tuple = ()        # batches dispatched per replica
    push_log: tuple = ()               # (replica, t_sched, start, end)
    #   per fired swap on the virtual timeline

    def as_row(self) -> dict:
        r = dataclasses.asdict(self)
        for k in ("p50_ms", "p95_ms", "p99_ms"):
            r[k] = round(r[k], 3)
        r["qps"] = round(r["qps"], 1)
        r["offered_qps"] = round(r["offered_qps"], 1)
        r["mean_batch"] = round(r["mean_batch"], 2)
        r["makespan_s"] = round(r["makespan_s"], 4)
        # fleet diagnostics stay off the row — existing single-server row
        # schemas must not drift (the JAX package's rows keep them);
        # run_fleet_cell adds n_replicas/retried columns explicitly
        for k in ("n_replicas", "retried", "replica_batches", "push_log"):
            r.pop(k)
        # push columns only exist on push-schedule rows — plain cells keep
        # their schema, as the JAX package's
        if r.pop("has_pushes"):
            r["push_p50_ms"] = round(r["push_p50_ms"], 3)
            r["push_max_ms"] = round(r["push_max_ms"], 3)
            r["mean_staleness_s"] = round(r["mean_staleness_s"], 4)
        else:
            for k in ("pushes", "push_p50_ms", "push_max_ms",
                      "mean_staleness_s"):
                r.pop(k)
        return r


# ---------------------------------------------------------------------------
# service models
# ---------------------------------------------------------------------------

def synthetic_service(base_s: float = 1e-3,
                      per_row_s: float = 1e-5) -> Callable:
    """Deterministic affine service model — the tests' clockwork scorer."""

    def service(batch: dict, n_valid: int) -> float:
        return base_s + per_row_s * n_valid

    return service


def measured_service(score_fn: Callable) -> Callable:
    """Wrap a real scorer: execute the padded batch, return its wall time.

    The time is stamped only once the scores are on the host (the
    server's ``score`` returns numpy, whose copy waits for the card).  The
    scores themselves are discarded — parity is the cache tests' job; the
    replay measures time.  The caller should run one warm-up batch first
    so first-call costs never land on the virtual timeline.
    """
    pass_valid = accepts_n_valid(score_fn)

    def service(batch: dict, n_valid: int) -> float:
        t0 = time.perf_counter()
        out = score_fn(batch, n_valid=n_valid) if pass_valid \
            else score_fn(batch)
        np.asarray(out)                       # materialize before stamping
        return time.perf_counter() - t0

    return service


def make_batcher(cfg: ReplayConfig) -> DeadlineBatcher:
    rc = RouterConfig(max_batch=cfg.max_batch, max_queue=cfg.max_queue,
                      max_wait_s=cfg.max_wait_s,
                      init_service_s=cfg.init_service_s)
    if cfg.policy == "deadline":
        return DeadlineBatcher(rc)
    if cfg.policy == "fixed":
        return FixedBatcher(rc)
    raise ValueError(f"unknown policy {cfg.policy!r}")


# ---------------------------------------------------------------------------
# the virtual-clock event loop
# ---------------------------------------------------------------------------

def _normalize_events(events, n_replicas: int) -> List[tuple]:
    """Events -> ``[(t, ((replica, fn), ...), rollout), ...]`` by time.

    Accepted forms per entry:

    * ``(t, fn)``              — a swap on replica 0 (single-server form);
    * ``(t, fn, replica)``     — a swap on one replica of the fleet.
      Both swap **in place**: the fn fires at ``t`` between batches and
      occupies the replica; its queued requests wait out the swap.
    * ``(t, [(replica, fn), ...])`` — a **staggered rollout**
      (``rollout=True``): replicas swap strictly one at a time, and each
      is taken out of admission rotation and *drained* first — its swap
      fires only once its queue is empty, so no request ever waits out a
      swap and the fleet p99 never eats one.  The next replica's drain
      begins at the previous swap's measured end.
    """
    norm = []
    for ev in (events or []):
        if len(ev) == 3:
            t_ev, fn, rep = ev
            pairs, rollout = ((int(rep), fn),), False
        else:
            t_ev, fn = ev
            if callable(fn):
                pairs, rollout = ((0, fn),), False
            else:
                pairs, rollout = tuple((int(r), f) for r, f in fn), True
        for r, _ in pairs:
            if not 0 <= r < n_replicas:
                raise ValueError(f"event replica {r} out of range "
                                 f"[0, {n_replicas})")
        norm.append((float(t_ev), pairs, rollout))
    return sorted(norm, key=lambda e: e[0])


def replay(service: Optional[Callable], requests: Sequence[dict],
           arrivals: np.ndarray, cfg: ReplayConfig,
           batcher: Optional[DeadlineBatcher] = None,
           events: Optional[Sequence] = None,
           n_replicas: int = 1,
           services: Optional[Sequence[Callable]] = None,
           batchers: Optional[Sequence[DeadlineBatcher]] = None
           ) -> ReplayReport:
    """Drive ``requests`` (arriving at ``arrivals``) through the batcher(s)
    into ``service``; returns the latency/throughput report.

    ``service(batch, n_valid) -> seconds`` is the service-time model
    (synthetic or measured).  Latency of request i = completion of its
    batch − its arrival; shed requests are counted, not timed.

    ``n_replicas`` > 1 replays a fleet: each replica gets its own batcher
    (``batchers``, default fresh ``make_batcher(cfg)`` each) and its own
    busy timeline on the shared virtual clock, and may get its own service
    model (``services``, one per replica — a fleet of measured scorers
    each with its own cache heat; default: ``service`` shared).  Admission
    follows the fleet contract: each arrival tries replicas in
    least-loaded order (fewest pending, then soonest free) and a shed on
    one replica retries on the next — only when *every* replica sheds is
    the request counted shed (``ReplayReport.retried`` counts the saves).
    Dispatch drains each replica's due batches onto its own timeline.

    ``events``: optional scheduled actions — the model-push hook (see
    ``_normalize_events`` for the accepted forms, including per-replica
    swaps and staggered rollouts).  Each fires once when the virtual clock
    reaches its time, strictly *between* dispatched batches (the same
    no-mixed-params guarantee as ``AsyncRouter.apply``): every batch
    dispatched before the event scores on the old model, every one after
    on the new.  Queued requests are untouched — a push never sheds.  The
    fn's wall time is recorded as push latency AND occupies that replica
    on the timeline (a swap blocks its scorer), so aggressive push
    schedules show up honestly in p99; ``mean_staleness_s`` reports how
    old the served model was on average under the schedule.
    """
    if len(requests) != len(arrivals):
        raise ValueError("requests and arrivals must align")
    n_rep = int(n_replicas)
    if n_rep < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    if batchers is not None:
        batchers = list(batchers)
        if len(batchers) != n_rep:
            raise ValueError(f"{len(batchers)} batchers != n_replicas "
                             f"{n_rep}")
    elif batcher is not None:
        if n_rep != 1:
            raise ValueError("pass batchers= (one per replica) for a "
                             "fleet replay")
        batchers = [batcher]
    else:
        batchers = [make_batcher(cfg) for _ in range(n_rep)]
    if services is not None:
        services = list(services)
        if len(services) != n_rep:
            raise ValueError(f"{len(services)} services != n_replicas "
                             f"{n_rep}")
    else:
        if service is None:
            raise ValueError("replay needs a service (or services=)")
        services = [service] * n_rep
    pending_events = _normalize_events(events, n_rep)
    lats: List[float] = []
    sizes: List[int] = []
    push_wall: List[float] = []
    push_log: List[tuple] = []
    stale_sum = 0.0
    shed = 0
    retried = 0
    deadline_miss = 0
    free = [0.0] * n_rep       # per-replica busy timeline
    last_push = [0.0] * n_rep  # virtual time each replica's model changed
    rep_batches = [0] * n_rep
    i, n = 0, len(requests)
    now = 0.0

    def dispatch(r, reqs, close_time):
        nonlocal deadline_miss, stale_sum
        batch, n_valid = stack_and_pad([q.features for q in reqs],
                                       cfg.max_batch)
        svc = float(services[r](batch, n_valid))
        start = max(close_time, free[r])
        done = start + svc
        free[r] = done
        batchers[r].observe(svc)
        sizes.append(n_valid)
        rep_batches[r] += 1
        stale_sum += (done - last_push[r]) * len(reqs)
        for q in reqs:
            lats.append(done - q.arrival)
            if q.deadline is not None and done > q.deadline:
                deadline_miss += 1

    draining = None            # replica out of rotation mid-rollout

    def fire_events(upto: float) -> None:
        nonlocal draining
        while pending_events and pending_events[0][0] <= upto:
            t_ev, pairs, rollout = pending_events[0]
            r, fn = pairs[0]
            if rollout:
                # rolling-deploy semantics: take r out of admission
                # rotation and let it drain; the swap fires only once
                # its queue is empty, so no admitted request ever waits
                # out a swap (events behind this one wait their turn)
                draining = r
                if len(batchers[r]):
                    break
            pending_events.pop(0)
            t0 = time.perf_counter()
            fn()
            wall = time.perf_counter() - t0
            push_wall.append(wall)
            # the swap occupies this replica: batches due during it
            # start after, on the new model (for a drained rollout the
            # queue is empty — only the replica's last in-flight batch
            # bounds the start)
            start = max(free[r], t_ev)
            free[r] = start + wall
            last_push[r] = t_ev
            push_log.append((r, t_ev, start, free[r]))
            if rollout:
                draining = None
                if len(pairs) > 1:
                    # the next replica begins draining at this swap's
                    # measured end — one replica mid-rollout at a time,
                    # the rest serving at full rotation
                    pending_events.append((free[r], pairs[1:], True))
                    pending_events.sort(key=lambda e: e[0])

    def admit(req, t, deadline):
        nonlocal shed, retried
        # the fleet admission contract: least-loaded first (fewest
        # pending, then soonest-free, then index); a shed retries on the
        # next replica and is terminal only when every replica sheds.
        # A draining replica is out of rotation (unless it is all there
        # is) — its queue must empty for its swap to fire.
        cand = [r for r in range(n_rep) if r != draining]
        if not cand:
            cand = list(range(n_rep))
        order = (cand if len(cand) == 1 else
                 sorted(cand, key=lambda r: (len(batchers[r]), free[r], r)))
        for k, r in enumerate(order):
            try:
                batchers[r].admit(req, t, deadline=deadline)
                if k:
                    retried += 1
                return
            except LoadShedError:
                continue
        shed += 1

    while i < n or any(len(b) for b in batchers) or pending_events:
        events_t = [] if i >= n else [float(arrivals[i])]
        for r in range(n_rep):
            t_close = batchers[r].close_at()
            if t_close is not None:
                # a due batch can only start once its replica frees up —
                # the busy-server semantics that let queue_full trip
                events_t.append(max(t_close, free[r]))
        if pending_events:
            t_ev, pairs, rollout = pending_events[0]
            if not (rollout and t_ev <= now and len(batchers[pairs[0][0]])):
                # a rollout blocked on its drain has no firing time of
                # its own — the draining queue's close events drive the
                # clock until it empties
                events_t.append(t_ev)
        if not events_t:
            break
        now = max(now, min(events_t))
        fire_events(now)
        while i < n and arrivals[i] <= now:
            t = float(arrivals[i])
            deadline = None if cfg.deadline_s is None else t + cfg.deadline_s
            admit(requests[i], t, deadline)
            i += 1
        for r in range(n_rep):
            while free[r] <= now:
                reqs = batchers[r].poll(now)
                if reqs is None:
                    break
                dispatch(r, reqs, now)

    lat_ms = np.sort(np.asarray(lats)) * 1e3
    span = float(arrivals[-1]) if n else 0.0
    # makespan from the busy timelines even when every request shed —
    # fired pushes still occupied the replicas (the old ``0.0 when no
    # completions`` hid that work entirely)
    makespan = max(max(free), span)
    p = (lambda q: percentile(lat_ms, q)) if len(lat_ms) else (lambda q: 0.0)
    pw = np.sort(np.asarray(push_wall)) * 1e3
    return ReplayReport(
        p50_ms=p(0.5), p95_ms=p(0.95), p99_ms=p(0.99),
        qps=len(lats) / makespan if makespan > 0 else 0.0,
        # guarded: a 1-request trace can arrive at t=0 exactly
        offered_qps=n / span if span > 0 else 0.0,
        completed=len(lats), shed=shed, batches=len(sizes),
        mean_batch=float(np.mean(sizes)) if sizes else 0.0,
        makespan_s=makespan, deadline_miss=deadline_miss,
        has_pushes=events is not None,
        pushes=len(push_wall),
        push_p50_ms=percentile(pw, 0.5) if len(pw) else 0.0,
        push_max_ms=float(pw[-1]) if len(pw) else 0.0,
        mean_staleness_s=stale_sum / len(lats) if lats else 0.0,
        n_replicas=n_rep, retried=retried,
        replica_batches=tuple(rep_batches), push_log=tuple(push_log))


# ---------------------------------------------------------------------------
# the benchmark grid
# ---------------------------------------------------------------------------

def run_cell(server, backend: str, cfg: ReplayConfig, *,
             zipf: float = 1.05, n_dense: Optional[int] = None,
             warm_batches: int = 64, service: Optional[Callable] = None
             ) -> dict:
    """One benchmark cell: backend × policy × zipf on a measured scorer.

    Warms the scorer (one padded batch) and the hot cache (``warm_batches``
    of prior traffic at the same skew) before the replay, so the recorded
    percentiles and hit rate describe steady state.
    """
    data_cfg = CtrDataConfig(
        vocab_sizes=server.cfg.vocab_sizes,
        n_dense=server.cfg.n_dense if n_dense is None else n_dense,
        batch_size=256, zipf_exponent=zipf, seed=cfg.seed + 7)
    stream = RequestStream(data_cfg)
    requests = stream.requests(cfg.n_requests)
    arrivals = poisson_arrivals(cfg.rate_hz, cfg.n_requests, seed=cfg.seed)

    cache = server.cache(backend)
    if cache is not None:
        cache.warm(stream.id_batches(warm_batches, start_step=10_000))
    score_fn = server.score_fn(backend)
    if service is None:
        # first call outside the timeline, then measure the real scorer
        batch, nv = stack_and_pad(requests[:1], cfg.max_batch)
        score_fn(batch, n_valid=nv)
        if cache is not None:
            cache.reset_stats()           # warm-up call is not traffic
        service = measured_service(score_fn)
    rep = replay(service, requests, arrivals, cfg)
    row = {"backend": backend, "policy": cfg.policy, "zipf": zipf,
           "max_batch": cfg.max_batch,
           "deadline_ms": (None if cfg.deadline_s is None
                           else round(cfg.deadline_s * 1e3, 2)),
           **rep.as_row()}
    stats = server.cache_stats(backend)
    if stats is not None:
        row["hit_rate"] = stats["hit_rate"]
        row["cache_resident"] = stats["resident_rows"]
    return row


def run_push_cell(server, backend: str, cfg: ReplayConfig, *,
                  publish_dir: str, push_steps: Sequence[int],
                  zipf: float = 1.05, drift_period: int = 0,
                  warm_batches: int = 64,
                  service: Optional[Callable] = None) -> dict:
    """One online-serving cell: replay (optionally drifting) traffic with
    ``server.push`` events scheduled on the virtual clock.

    ``push_steps``: publish steps in ``publish_dir`` (an ``OnlineTrainer``
    run's ``[p.step for p in publishes]``).  The first is pushed *before*
    cache warm-up (the serving baseline); the rest fire evenly spaced
    across the arrival span, so the row's p99 includes the swaps and
    ``mean_staleness_s`` reflects the push cadence.  ``drift_period`` > 0
    drifts the request stream itself (in underlying 256-request batch
    steps), making the cell the full online story: drifting traffic
    scored by a model republished mid-replay.
    """
    push_steps = list(push_steps)
    if not push_steps:
        raise ValueError("run_push_cell needs at least one publish step")
    server.push(backend, step=push_steps[0], ckpt_dir=publish_dir)
    data_cfg = CtrDataConfig(
        vocab_sizes=server.cfg.vocab_sizes, n_dense=server.cfg.n_dense,
        batch_size=256, zipf_exponent=zipf, seed=cfg.seed + 7,
        drift_period=drift_period)
    stream = RequestStream(data_cfg)
    requests = stream.requests(cfg.n_requests)
    arrivals = poisson_arrivals(cfg.rate_hz, cfg.n_requests, seed=cfg.seed)

    cache = server.cache(backend)
    if cache is not None:
        # warm on the phase the replay opens in (a drifting stream's
        # far-future steps are a different phase = useless heat), the
        # "recent traffic window" a production cache would hold
        cache.warm(stream.id_batches(warm_batches, start_step=0))
    score_fn = server.score_fn(backend)
    if service is None:
        batch, nv = stack_and_pad(requests[:1], cfg.max_batch)
        score_fn(batch, n_valid=nv)
        if cache is not None:
            cache.reset_stats()
        service = measured_service(score_fn)
    span = float(arrivals[-1])
    later = push_steps[1:]
    events = [(span * (k + 1) / (len(later) + 1),
               lambda s=s: server.push(backend, step=s,
                                       ckpt_dir=publish_dir))
              for k, s in enumerate(later)]
    rep = replay(service, requests, arrivals, cfg, events=events)
    row = {"backend": backend, "policy": cfg.policy, "zipf": zipf,
           "max_batch": cfg.max_batch,
           "deadline_ms": (None if cfg.deadline_s is None
                           else round(cfg.deadline_s * 1e3, 2)),
           "drift_period": drift_period, "push_steps": len(push_steps),
           **rep.as_row()}
    stats = server.cache_stats(backend)
    if stats is not None:
        row["hit_rate"] = stats["hit_rate"]
        row["cache_resident"] = stats["resident_rows"]
    return row


def run_grid(server, *, policies: Sequence[str] = ("deadline", "fixed"),
             zipfs: Sequence[float] = (1.05,),
             backends: Optional[Sequence[str]] = None,
             base: Optional[ReplayConfig] = None,
             warm_batches: int = 64,
             service: Optional[Callable] = None) -> List[dict]:
    """backend × policy × zipf sweep; one row dict per cell.

    Every cell starts from a cold cache: ``server.reset_caches()`` drops
    the resident store AND the sketch heat before each cell's own warm-up,
    so no cell's traffic distribution leaks into the next one's admission
    decisions or hit rate (resetting only the *stats* let z1.05 heat
    pollute the z4.0 control's resident set) and the grid's rows are
    independent of cell order.
    """
    base = base if base is not None else ReplayConfig()
    rows = []
    for zipf in zipfs:
        for backend in (backends if backends is not None
                        else server.backends):
            for policy in policies:
                server.reset_caches()
                cell = dataclasses.replace(base, policy=policy)
                rows.append(run_cell(server, backend, cell, zipf=zipf,
                                     warm_batches=warm_batches,
                                     service=service))
    return rows


# ---------------------------------------------------------------------------
# fleet cells
# ---------------------------------------------------------------------------

def _fleet_cache_row(fleet, backend: str, row: dict) -> dict:
    """Attach fleet-aggregated cache columns (hits pooled over replicas)."""
    stats = [s for s in fleet.cache_stats(backend) if s is not None]
    if stats:
        hits = sum(s["hits"] for s in stats)
        misses = sum(s["misses"] for s in stats)
        row["hit_rate"] = round(hits / (hits + misses), 4) \
            if hits + misses else 0.0
        row["cache_resident"] = sum(s["resident_rows"] for s in stats)
    return row


def _fleet_services(fleet, backend: str, requests, cfg: ReplayConfig):
    """Per-replica measured scorers, first called outside the timeline."""
    batch, nv = stack_and_pad(requests[:1], cfg.max_batch)
    services = []
    for rep in fleet.replicas:
        fn = rep.score_fn(backend)
        fn(batch, n_valid=nv)             # warm the scorer off the clock
        services.append(measured_service(fn))
    fleet.reset_cache_stats()             # warm-up calls are not traffic
    return services


def run_fleet_cell(fleet, backend: str, cfg: ReplayConfig, *,
                   zipf: float = 1.05, warm_batches: int = 64,
                   services: Optional[Sequence[Callable]] = None) -> dict:
    """One fleet benchmark cell: N replicas behind the fleet admission
    path on a measured per-replica scorer.

    The offered load is ``cfg.rate_hz`` for the whole fleet — the caller
    scales it with the replica count (the r4 row runs at 4× the r1 row's
    rate).  Every replica's cache warms on the same prior-traffic window,
    then each serves its own share of the replay with its own heat.
    """
    server0 = fleet.replicas[0]
    data_cfg = CtrDataConfig(
        vocab_sizes=server0.cfg.vocab_sizes, n_dense=server0.cfg.n_dense,
        batch_size=256, zipf_exponent=zipf, seed=cfg.seed + 7)
    stream = RequestStream(data_cfg)
    requests = stream.requests(cfg.n_requests)
    arrivals = poisson_arrivals(cfg.rate_hz, cfg.n_requests, seed=cfg.seed)
    fleet.warm_caches(list(stream.id_batches(warm_batches,
                                             start_step=10_000)))
    if services is None:
        services = _fleet_services(fleet, backend, requests, cfg)
    rep = replay(None, requests, arrivals, cfg,
                 n_replicas=len(fleet.replicas), services=services)
    row = {"backend": backend, "policy": cfg.policy, "zipf": zipf,
           "max_batch": cfg.max_batch,
           "deadline_ms": (None if cfg.deadline_s is None
                           else round(cfg.deadline_s * 1e3, 2)),
           "n_replicas": rep.n_replicas, "retried": rep.retried,
           **rep.as_row()}
    return _fleet_cache_row(fleet, backend, row)


def run_fleet_push_cell(fleet, backend: str, cfg: ReplayConfig, *,
                        publish_dir: str, push_steps: Sequence[int],
                        staggered: bool = True, zipf: float = 1.05,
                        warm_batches: int = 64,
                        services: Optional[Sequence[Callable]] = None
                        ) -> dict:
    """One fleet push cell: replay with fleet-wide model pushes scheduled
    on the virtual clock, either **staggered** (one replica swaps at a
    time, the rest keep serving — ``ReplicaFleet.rollout_event``) or
    **synchronized** (every replica swaps at the same virtual instant —
    the control whose p99 eats the swap).

    The first ``push_steps`` entry is rolled onto every replica *before*
    warm-up (the serving baseline), and the caches then fully reset — so
    a staggered and a synchronized cell on the same trace start from the
    same deterministic fleet state and their p99 gap is the rollout
    policy's alone.
    """
    push_steps = list(push_steps)
    if not push_steps:
        raise ValueError("run_fleet_push_cell needs at least one "
                         "publish step")
    fleet.push_all(backend, step=push_steps[0], ckpt_dir=publish_dir)
    fleet.reset_caches()
    server0 = fleet.replicas[0]
    data_cfg = CtrDataConfig(
        vocab_sizes=server0.cfg.vocab_sizes, n_dense=server0.cfg.n_dense,
        batch_size=256, zipf_exponent=zipf, seed=cfg.seed + 7)
    stream = RequestStream(data_cfg)
    requests = stream.requests(cfg.n_requests)
    arrivals = poisson_arrivals(cfg.rate_hz, cfg.n_requests, seed=cfg.seed)
    fleet.warm_caches(list(stream.id_batches(warm_batches, start_step=0)))
    if services is None:
        services = _fleet_services(fleet, backend, requests, cfg)
    span = float(arrivals[-1])
    later = push_steps[1:]
    events = []
    for k, s in enumerate(later):
        t_ev = span * (k + 1) / (len(later) + 1)
        if staggered:
            events.append(fleet.rollout_event(
                t_ev, backend, step=s, ckpt_dir=publish_dir))
        else:
            events.extend(fleet.synchronized_events(
                t_ev, backend, step=s, ckpt_dir=publish_dir))
    rep = replay(None, requests, arrivals, cfg,
                 n_replicas=len(fleet.replicas), services=services,
                 events=events)
    row = {"backend": backend, "policy": cfg.policy, "zipf": zipf,
           "max_batch": cfg.max_batch,
           "deadline_ms": (None if cfg.deadline_s is None
                           else round(cfg.deadline_s * 1e3, 2)),
           "n_replicas": rep.n_replicas, "retried": rep.retried,
           "push_mode": "staggered" if staggered else "synchronized",
           "push_steps": len(push_steps),
           **rep.as_row()}
    return _fleet_cache_row(fleet, backend, row)
