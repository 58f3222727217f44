"""Deterministic fault injection for ``train_loop.run`` (PyTorch port of
``FaultClock`` and ``FaultPlan`` from ``repro.train.elastic``).

``FaultPlan`` / ``FaultClock`` inject slow steps, NaN batches and raised
exceptions at chosen *global* steps, with step time advanced on a
synthetic monotonic clock so the straggler EWMA is reproducible down to
the float.  Both are host code: the wrapped step reads the step with
``int(state["step"])``.  The rest of the JAX module, the mesh re-slice
(``ResliceController``, ``train_state_specs``), comes with the port of
distribution (ROADMAP module item 6); a ``reslice_fn`` of the caller's
own still drives ``train_loop.run``'s re-slice hook.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Set

import numpy as np

__all__ = ["FaultClock", "FaultPlan"]


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
        clock by the planned duration of every executed step."""

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
