"""Streaming online trainer: train on a drifting CTR stream, publish
delta checkpoints a serving tier hot-swaps with zero downtime (PyTorch
port of ``repro.train.online``).

Production recsys models are never "done": the id distribution drifts
(``data/synthetic_ctr.py`` with ``drift_period > 0``) and P(y|x) itself
moves, so the trainer runs forever and periodically *publishes* — and the
ROBE serving story (a cache-resident array) only matters if that array
can be refreshed while serving.  This module is the trainer half of the
loop; ``serve.server.EmbeddingServer.push`` is the consumer half.

The publish protocol
--------------------
* Publish 0 (and every ``full_every``-th after) is a **full** atomic
  snapshot (``checkpoint.save``) — the base a delta chain terminates at.
* Every other publish is a **delta** (``checkpoint.save_delta``): only
  the leaves whose bytes changed vs the previous publish, plus a manifest
  of *touched embedding groups* — ``{field: row ids}`` recorded from the
  training batches since the previous publish.  ``restore_delta`` walks
  the chain; ``HotRowCache.invalidate`` drops exactly those rows.

Touched-row exactness: rows the recorder never saw must be bit-identical
under the new params — true for optimizers whose update is zero wherever
the gradient is zero (plain SGD, adagrad: v only accumulates where g≠0).
Momentum/adam state keeps moving rows after their gradient is gone, which
would silently violate the contract, so ``OnlineTrainer`` refuses those
unless ``online_cfg.unsafe_optimizer`` acknowledges it (a full-snapshot-
only publish cadence — ``full_every=1`` — is the safe alternative).

Training itself is the existing fault-tolerant machinery, unchanged:
``build_train_step`` (including the qrobe ``project`` requantization
hook) and ``train_loop.run`` in publish-interval segments — so NaN
restore/skip, bounded restarts, and the straggler → ``reslice_fn`` path
all compose with publishing (``fault_plan`` wires a
``train.elastic.FaultPlan`` drill straight through).  On the card the
step runs the Hopper kernels of the substrate's lookup and the
interaction, forward and backward; a publish copies each param leaf to
the host once.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.recsys import (RecsysConfig, init_params, loss_fn,
                                       make_project_fn)
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import train_loop
from repro_torch.train.optimizer import (Optimizer, OptimizerConfig,
                                         make_optimizer)
from repro_torch.tree import leaves, tree_map

__all__ = ["OnlineConfig", "PublishRecord", "OnlineReport", "RowRecorder",
           "OnlineTrainer"]


#: optimizer kinds whose update is exactly zero where the gradient is zero
#: — the touched-row invalidation contract (module doc) holds for these
_ZERO_GRAD_SAFE = ("sgd", "adagrad")


@dataclasses.dataclass(frozen=True)
class OnlineConfig:
    """Publish cadence + delta policy for an ``OnlineTrainer``."""

    publish_dir: str
    publish_every: int = 20       # train steps between publishes
    full_every: int = 5           # every k-th publish is a full snapshot
    delta_threshold: float = 0.0  # max-|Δ| per leaf under which it's
    #   "unchanged" (0.0 = any byte change); nonzero trades push traffic
    #   for bounded staleness on slow-moving MLP leaves
    unsafe_optimizer: bool = False  # acknowledge a momentum/adam optimizer
    #   (touched-row exactness lost; see module doc)


@dataclasses.dataclass(frozen=True)
class PublishRecord:
    """One publish: what was written and how much of the model moved."""

    step: int
    kind: str                     # "full" | "delta"
    path: str
    n_leaves: int
    n_changed: int                # changed leaves (== n_leaves for full)
    n_touched: int                # touched embedding rows in the manifest
    wall_s: float


@dataclasses.dataclass
class OnlineReport:
    """Aggregate of the per-segment ``RunReport``s plus the publish log."""

    steps_done: int
    publishes: List[PublishRecord]
    final_loss: float
    losses: list
    restarts: int
    nan_events: int
    straggler_steps: int
    reslices: int
    state: dict = None


class RowRecorder:
    """Which (field, row id) pairs appeared in training batches since the
    last publish — the delta manifest's touched-group sets.

    Recording happens at batch *fetch* (inside the trainer's ``batch_at``
    wrapper), so a rewound-and-replayed step records again: the set is a
    superset of the rows the optimizer actually moved, which is the safe
    direction — invalidating an unmoved row just refetches identical
    bytes.
    """

    def __init__(self, n_fields: int):
        self._sets = [set() for _ in range(n_fields)]

    def record(self, batch: dict) -> None:
        for key in ("sparse", "sparse_bag"):
            ids = batch.get(key)
            if ids is None:
                continue
            ids = np.asarray(ids)
            for f in range(min(ids.shape[1], len(self._sets))):
                self._sets[f].update(np.unique(ids[:, f]).tolist())

    def drain(self) -> Dict[int, list]:
        """Touched map {field: sorted ids}; resets the recorder."""
        out = {f: sorted(s) for f, s in enumerate(self._sets) if s}
        self._sets = [set() for _ in self._sets]
        return out


class OnlineTrainer:
    """Train on a step-indexed stream, publishing to ``publish_dir``.

    ``stream`` needs only ``batch_at(step)`` (a ``CtrStream``, drifting or
    not).  The loss/step machinery is the standard recsys stack:
    ``loss_fn`` + ``build_train_step(project=make_project_fn(cfg))``, so
    every substrate trains exactly as it does offline — including qrobe's
    int8 requantization fold.  ``params`` (on any device; e.g. carried
    from the JAX package by ``convert.params_from_numpy``) or, without
    them, ``init_params`` from a generator seeded ``seed`` on ``device``
    (default ``cuda``).
    """

    def __init__(self, model_cfg: RecsysConfig, stream,
                 online_cfg: OnlineConfig, *,
                 optimizer: Optional[Optimizer] = None,
                 train_cfg: Optional[train_loop.TrainConfig] = None,
                 params: Optional[dict] = None, seed: int = 0,
                 device=None):
        self.model_cfg = model_cfg
        self.stream = stream
        self.online_cfg = online_cfg
        self.optimizer = optimizer if optimizer is not None else \
            make_optimizer(OptimizerConfig(kind="adagrad", lr=0.05))
        self.train_cfg = train_cfg if train_cfg is not None else \
            train_loop.TrainConfig(checkpoint_every=10_000, log_every=10_000)
        okind = self.optimizer.cfg.kind
        if okind not in _ZERO_GRAD_SAFE and not online_cfg.unsafe_optimizer:
            raise ValueError(
                f"optimizer {okind!r} moves zero-gradient rows (momentum / "
                f"adam state), breaking the delta manifest's touched-row "
                f"exactness; use one of {_ZERO_GRAD_SAFE}, publish full "
                f"snapshots only (full_every=1), or acknowledge with "
                f"OnlineConfig(unsafe_optimizer=True)")
        if params is None:
            dev = resolve_device(device)
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            params = init_params(model_cfg, gen, dev)
        self.state = train_loop.init_state(params, self.optimizer,
                                           self.train_cfg)
        self._step_fn = train_loop.build_train_step(
            lambda p, b: loss_fn(p, model_cfg, b), self.optimizer,
            self.train_cfg, project=make_project_fn(model_cfg))
        self.recorder = RowRecorder(model_cfg.n_fields)
        self.publishes: List[PublishRecord] = []
        self._base_params = None      # host snapshot of the last publish
        self._base_step: Optional[int] = None

    # -- publishing ---------------------------------------------------------

    def publish(self, step: int) -> PublishRecord:
        """Publish the current params at global ``step`` (full or delta per
        the ``full_every`` cadence) and return the record."""
        t0 = time.monotonic()
        cfg = self.online_cfg
        # one copy of each leaf to the host (a copy on the CPU too: the
        # next publish diffs against it)
        params = tree_map(lambda x: x.detach().to("cpu", copy=True).numpy(),
                          self.state["params"])
        n_leaves = len(leaves(params))
        touched = self.recorder.drain()
        n_touched = sum(len(v) for v in touched.values())
        if self._base_params is None \
                or len(self.publishes) % cfg.full_every == 0:
            # keep_last=0: publish retention is delta-aware (_gc_deltas);
            # blind keep-last-k would break chains still anchored on an
            # older full
            path = ckpt_lib.save(cfg.publish_dir, step, params, keep_last=0)
            rec = PublishRecord(step=step, kind="full", path=path,
                                n_leaves=n_leaves, n_changed=n_leaves,
                                n_touched=n_touched,
                                wall_s=time.monotonic() - t0)
        else:
            path = ckpt_lib.save_delta(
                cfg.publish_dir, step, params, self._base_params,
                self._base_step, threshold=cfg.delta_threshold,
                touched=touched)
            n_changed = sum(m["changed"] for m in
                            ckpt_lib._load_manifest(path)["leaves"])
            rec = PublishRecord(step=step, kind="delta", path=path,
                                n_leaves=n_leaves, n_changed=n_changed,
                                n_touched=n_touched,
                                wall_s=time.monotonic() - t0)
        self._base_params, self._base_step = params, step
        self.publishes.append(rec)
        return rec

    # -- the online loop ----------------------------------------------------

    def run(self, n_steps: int, *, fault_plan=None,
            reslice_fn: Optional[Callable] = None,
            ckpt_dir: Optional[str] = None,
            on_publish: Optional[Callable] = None) -> OnlineReport:
        """Train to global step ``n_steps``, publishing every
        ``publish_every`` steps (plus an initial full publish at the
        current step, so a server always has a base to push).

        ``fault_plan`` (``train.elastic.FaultPlan``): wraps the step/batch
        functions and drives the loop's timer with the plan's
        deterministic clock, so slow/NaN/crash drills — including the
        straggler → ``reslice_fn`` re-slice — run mid-publish-cycle.
        ``ckpt_dir``: fault-tolerance checkpoints (separate from the
        publish dir, which holds only what consumers should see).
        ``on_publish(record)``: called after every publish — the serving
        test/bench hook (e.g. ``server.push`` on a schedule).
        """
        step_fn = self._step_fn
        batch_at: Callable[[int], dict] = self._batch_at
        timer: Callable[[], float] = time.monotonic
        if fault_plan is not None:
            step_fn = fault_plan.wrap_step_fn(step_fn)
            batch_at = fault_plan.wrap_batch_at(batch_at)
            timer = fault_plan.clock
        self._live_step_fn = step_fn
        wrapped_reslice = None
        if reslice_fn is not None:
            def wrapped_reslice(state, step):
                # capture the re-jitted step_fn: train_loop.run swaps it
                # only inside the current segment, and the next segment
                # must keep training on the rebuilt mesh
                state, new_fn = reslice_fn(state, step)
                self._live_step_fn = new_fn
                return state, new_fn

        start = int(self.state["step"])
        totals = dict(restarts=0, nan_events=0, straggler_steps=0,
                      reslices=0)
        losses: list = []
        if not self.publishes:
            rec = self.publish(start)
            if on_publish is not None:
                on_publish(rec)
        step = start
        while step < n_steps:
            target = min(n_steps, step + self.online_cfg.publish_every)
            rep = train_loop.run(self.state, self._live_step_fn, batch_at,
                                 target, self.train_cfg, ckpt_dir=ckpt_dir,
                                 reslice_fn=wrapped_reslice, timer=timer)
            self.state = rep.state
            losses.extend(rep.losses)
            totals["restarts"] += rep.restarts
            totals["nan_events"] += rep.nan_events
            totals["straggler_steps"] += rep.straggler_steps
            totals["reslices"] += rep.reslices
            step = int(self.state["step"])
            rec = self.publish(step)
            if on_publish is not None:
                on_publish(rec)
        return OnlineReport(
            steps_done=step - start, publishes=list(self.publishes),
            final_loss=losses[-1] if losses else float("nan"),
            losses=losses, state=self.state, **totals)

    def _batch_at(self, step: int) -> dict:
        batch = self.stream.batch_at(step)
        self.recorder.record(batch)
        return batch
