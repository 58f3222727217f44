"""Elastic re-slice: the straggler flag turned into a mesh rebuild
(PyTorch port of ``repro.train.elastic``).

* ``ResliceController`` -- the ``reslice_fn`` that ``train_loop.run``
  calls when the (agreed) straggler monitor trips: it (1) builds the
  degraded context (``launch.mesh.degrade_context`` halves ``model`` by
  default; collective over the world, so every rank builds it), (2)
  re-resolves the state's spec tree against the survivors, (3) restores
  the checkpoint the loop just flushed onto them
  (``checkpoint.restore_onto``), or, when no checkpoint matches, gathers
  the live state over the old mesh and places it, (4) rebuilds the step
  through the caller's ``build_step`` hook and (5) swaps the new context
  in last, once nothing can fail.

  Here a loop per rank differs from the JAX package's single controller:
  the ranks that the degraded mesh drops get no step function back and
  leave ``run`` at the re-slice step (``RunReport.left_at``); they must
  stay alive until then, since building the survivors' process groups is
  collective over the whole world.

* ``FaultPlan`` / ``FaultClock`` -- deterministic fault injection: slow
  steps, NaN batches and raised exceptions at chosen *global* steps, with
  step time advanced on a synthetic monotonic clock so the straggler EWMA
  is reproducible down to the float.  Both are host code: the wrapped
  step reads the step with ``int(state["step"])``.

Re-slice contract of the embedding backends: ``param_specs(spec, rules,
mesh=degraded)`` returns a layout legal on the survivors (replicated
substrates the same tree; ``full`` rows and ZeRO-3 ``robe`` re-shard over
the surviving axes); divisibility against the checkpoint's global shapes
is enforced by ``dist.api.prune_specs``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Set

import numpy as np

from repro_torch.dist import api as dist
from repro_torch.dist import collectives as coll
from repro_torch.dist.api import P
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.tree import tree_map

__all__ = ["FaultClock", "FaultPlan", "ResliceEvent", "ResliceController",
           "train_state_specs"]


class FaultClock:
    """A monotonic clock that advances only when told.

    Passed as ``run(..., timer=plan.clock)`` so step durations — and
    therefore the straggler EWMA — come from the plan, not the wall."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def __call__(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        self._t += float(dt)


@dataclasses.dataclass
class FaultPlan:
    """Deterministic fault injection for ``train_loop.run``.

    Faults fire at *global* steps (the value of ``state["step"]`` /
    ``batch_at``'s argument), so a plan composes with checkpoint resume:

    * ``slow_steps``  — step → synthetic seconds; every other step takes
      ``base_dt``.  Wrap the step fn AND pass ``timer=plan.clock``.
    * ``nan_steps``   — steps whose batches get every float leaf poisoned
      to NaN (the loss goes NaN; the loop must restore + skip).  Wrap
      ``batch_at``; poisoning is pure per step, as resume requires.
    * ``raise_steps`` — step → message; the wrapped step fn raises
      RuntimeError ONCE per step (like a node failure: the retry after
      restart succeeds).

    Caveat: ``slow``/``raise`` key off ``state["step"]`` while ``nan``
    keys off ``batch_at``'s argument; the two agree except in the window
    after a NaN restore (the loop skips the poisoned batch forward while
    the restored state rewinds — train_loop's long-standing skip-don't-
    rewind semantics), so don't plan overlapping faults inside it.
    """

    slow_steps: Dict[int, float] = dataclasses.field(default_factory=dict)
    nan_steps: Set[int] = dataclasses.field(default_factory=set)
    raise_steps: Dict[int, str] = dataclasses.field(default_factory=dict)
    base_dt: float = 0.01
    clock: FaultClock = dataclasses.field(default_factory=FaultClock)
    _raised: Set[int] = dataclasses.field(default_factory=set, init=False)

    def wrap_step_fn(self, step_fn: Callable) -> Callable:
        """Raise at ``raise_steps`` (once each) and advance the fault
        clock by the planned duration of every executed step (the wrapper
        keeps the step's attributes, its ``param_specs`` among them)."""

        @functools.wraps(step_fn)
        def wrapped(state, batch):
            step = int(state["step"])
            if step in self.raise_steps and step not in self._raised:
                self._raised.add(step)
                raise RuntimeError(self.raise_steps[step])
            out = step_fn(state, batch)
            self.clock.advance(self.slow_steps.get(step, self.base_dt))
            return out

        return wrapped

    def wrap_batch_at(self, batch_at: Callable[[int], dict]
                      ) -> Callable[[int], dict]:
        """Poison every float leaf of the batch to NaN at ``nan_steps``."""

        def poison(v):
            v = np.asarray(v)
            if np.issubdtype(v.dtype, np.floating):
                return np.full_like(v, np.nan)
            return v

        def wrapped(step: int) -> dict:
            batch = batch_at(step)
            if step in self.nan_steps:
                batch = {k: poison(v) for k, v in batch.items()}
            return batch

        return wrapped


# ---------------------------------------------------------------------------
# the re-slice controller
# ---------------------------------------------------------------------------

def train_state_specs(state: dict, pspecs, rules=None) -> dict:
    """``P`` tree for a ``train_loop.init_state`` dict.

    ``params`` takes ``pspecs``; ``opt`` mirrors it leaf for leaf
    (``dist.param_specs.state_specs``); the error-feedback residuals
    (``ef``) carry a leading per-data-shard axis and live sharded over the
    data axes when ``rules`` are given.  Everything else replicates.
    """
    from repro_torch.dist.param_specs import state_specs
    dp = rules.get("batch") if rules else None
    out = {}
    for k, sub in state.items():
        if k == "params":
            out[k] = pspecs
        elif k == "opt":
            out[k] = state_specs(pspecs, sub)
        elif k == "ef" and dp is not None:
            out[k] = tree_map(lambda x: None if x is None else P(dp), sub)
        else:
            out[k] = tree_map(lambda x: None if x is None else P(), sub)
    return out


@dataclasses.dataclass
class ResliceEvent:
    step: int                 # global step the rebuild happened at
    devices_before: int
    devices_after: int
    restored_step: Optional[int]   # manifest step, None = live re-place


class ResliceController:
    """``reslice_fn`` for ``train_loop.run``.

    Hooks:

    * ``degrade(old_ctx) -> DistContext`` -- the surviving mesh; default
      halves ``model`` (``launch.mesh.degrade_context``).  Every rank of
      the world calls it.
    * ``state_specs(ctx, state) -> P tree`` -- the whole train state's
      specs under ``ctx``'s rules (e.g. ``train_state_specs(state,
      recsys_specs(..., mesh=ctx.mesh), ctx.rules)``).
    * ``build_step(new_ctx) -> step_fn`` -- the step on the survivors (a
      ``build_train_step(..., specs=)`` with the new live specs).

    A ``ResliceEvent`` per rebuild is appended to ``events``.  A rank the
    new mesh drops gets ``(state, None)`` back: ``run`` then leaves its
    loop.
    """

    def __init__(self, *, state_specs: Callable[[Any, dict], Any],
                 build_step: Callable[[Any], Callable],
                 ckpt_dir: Optional[str] = None,
                 degrade: Optional[Callable[[Any], Any]] = None):
        if degrade is None:
            from repro_torch.launch.mesh import degrade_context
            degrade = degrade_context
        self.degrade = degrade
        self.state_specs = state_specs
        self.build_step = build_step
        self.ckpt_dir = ckpt_dir
        self.events: List[ResliceEvent] = []

    def _live_replace(self, old_ctx, new_ctx, state):
        """Gather the live state over the old mesh (every old rank) and,
        on the survivors, place it by the new pruned specs.  The old
        layout is read as live: a sharded dim's global size is its local
        size times its axes' size."""
        specs = self.state_specs(old_ctx, state)
        specs = dist.prune_specs(
            specs, dist.global_shapes(state, specs, old_ctx), old_ctx.mesh)
        whole = dist.gather(state, specs, old_ctx)
        if not new_ctx.is_member:
            return state
        specs = dist.prune_specs(self.state_specs(new_ctx, state), whole,
                                 new_ctx.mesh)
        return dist.place(whole, specs, new_ctx, device=old_ctx.device)

    def __call__(self, state: dict, step: int):
        old_ctx = dist.current()
        if old_ctx is None:
            raise RuntimeError("reslice needs an active DistContext "
                               "(run inside `with dist.use(ctx):`)")
        new_ctx = self.degrade(old_ctx)
        restored = None
        if self.ckpt_dir is not None and new_ctx.is_member:
            # pin the snapshot the loop just flushed: a stale dir must not
            # rewind training to whatever happens to be newest
            restored = ckpt_lib.restore_onto(
                self.ckpt_dir, state, new_ctx,
                self.state_specs(new_ctx, state), step=step)
        # every old rank takes the same branch: the live re-place below is
        # a collective over the old mesh
        if bool(coll.agree_all(restored is not None or not new_ctx.is_member,
                               old_ctx)):
            # every survivor restored the pinned snapshot
            restored_step = step
            if restored is not None:
                state, manifest = restored
                restored_step = int(manifest["step"])
        else:
            restored_step = None
            state = self._live_replace(old_ctx, new_ctx, state)
        step_fn = self.build_step(new_ctx) if new_ctx.is_member else None
        # swap last, once nothing can fail: if degrade/restore/build raise,
        # run() takes it as a restart and the healthy context stays active
        dist.swap(new_ctx)
        self.events.append(ResliceEvent(
            step=step, devices_before=old_ctx.n_devices,
            devices_after=new_ctx.n_devices, restored_step=restored_step))
        return state, step_fn
