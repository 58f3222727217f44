"""Train-step builder + fault-tolerant runner (PyTorch port of
``repro.train.train_loop``).

``build_train_step`` returns one function:
    state, metrics = step_fn(state, batch)
with gradient accumulation (microbatches in a Python loop, where the JAX
package scans), the NaN guard and the optional post-update ``project``
hook.  PyTorch runs it eagerly: nothing is compiled, and on the card the
DLRM's sparse work runs in the Hopper kernels of ``kernels/ops.py``,
forward and backward.

``run`` is the production loop: a checkpoint every k steps (async,
atomic, ``train/checkpoint.py``), resume from the newest one, NaN ->
restore + skip the batch, straggler monitor (step-time EWMA, warm-up
aware), elastic re-slice hook, injected faults and bounded restarts that
rewind to the newest checkpoint, with an injectable clock.  Compressed
gradient all-reduce (``grad_compression``) and restoring onto a mesh come
with the port of distribution (ROADMAP module item 6) and raise.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.optimizer import F32, Optimizer
from repro_torch.tree import leaves, tree_map, unflatten


@dataclasses.dataclass
class TrainConfig:
    grad_accum: int = 1
    checkpoint_every: int = 100
    keep_last: int = 3
    max_restarts: int = 3
    log_every: int = 10
    grad_compression: str = "none"       # none (bf16 | int8: not ported)
    straggler_factor: float = 3.0        # step > f × EWMA ⇒ flagged
    straggler_patience: int = 3          # consecutive flags ⇒ re-slice
    #   (only with a reslice_fn; the EWMA skips warm-up steps -- the first
    #   step, and the step after a restore, a restart, a checkpoint save or
    #   a re-slice)


def _no_compression(cfg: TrainConfig) -> None:
    if cfg.grad_compression != "none":
        raise NotImplementedError(
            f"grad_compression={cfg.grad_compression!r} is not yet ported: "
            f"it comes with the port of distribution (ROADMAP module item 6)")


def build_train_step(loss_fn: Callable, optimizer: Optimizer,
                     cfg: TrainConfig,
                     project: Optional[Callable] = None) -> Callable:
    """loss_fn(params, batch) -> (loss, metrics dict of scalars).

    Gradients come from ``torch.autograd.grad`` over the float leaves of
    the params; integer leaves get no gradient (None) and the optimizer
    freezes them.  ``project`` (optional) is applied to the params after
    every update (the quantized substrates' requantization hook; see
    ``models.recsys.make_project_fn``).  The NaN guard keeps the old params
    and optimizer state, leaf by leaf with ``torch.where`` on a flag that
    stays on the device, when the loss or any grad is not finite.
    """
    _no_compression(cfg)
    if cfg.grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {cfg.grad_accum}")

    def value_and_grad(params, batch):
        flat = leaves(params)
        live = [i for i, p in enumerate(flat) if p.is_floating_point()]
        xs = list(flat)
        for i in live:
            xs[i] = flat[i].detach().requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(unflatten(params, xs), batch)[0]
            gs = torch.autograd.grad(loss, [xs[i] for i in live],
                                     allow_unused=True)
        grads = [None] * len(flat)
        for i, g in zip(live, gs):
            grads[i] = torch.zeros_like(flat[i]) if g is None else g
        return loss.detach(), grads

    def grads_of(params, batch):
        if cfg.grad_accum == 1:
            return value_and_grad(params, batch)
        n = cfg.grad_accum
        # microbatch k is rows k*B/n .. (k+1)*B/n - 1, as the JAX
        # package's reshape to [n, B/n, ...] cuts it
        mbs = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
               for k, v in batch.items()}
        loss, acc = 0.0, None
        for k in range(n):
            l, g = value_and_grad(params, {key: v[k] for key, v in
                                           mbs.items()})
            loss = loss + l
            # f32 accumulators; leaves with no grad stay None
            acc = [None if gg is None else gg.to(F32) for gg in g] \
                if acc is None else \
                [None if gg is None else a + gg for a, gg in zip(acc, g)]
        inv = 1.0 / n
        return loss * inv, [None if a is None else a * inv for a in acc]

    def step_fn(state, batch):
        params, opt_state, step = state["params"], state["opt"], state["step"]
        loss, flat_g = grads_of(params, batch)
        with torch.no_grad():
            finite = torch.isfinite(loss)
            for g in flat_g:
                if g is not None:
                    finite &= torch.all(torch.isfinite(g))
            grads = unflatten(params, flat_g)
            new_params, new_opt = optimizer.update(params, grads, opt_state,
                                                   step)
            params = tree_map(lambda new, old: torch.where(finite, new, old),
                              new_params, params)
            opt_state = tree_map(
                lambda new, old: torch.where(finite, new, old), new_opt,
                opt_state)
            if project is not None:
                # idempotent on a skipped update: a between-steps state
                # projects to itself
                params = project(params)
        state = dict(state, params=params, opt=opt_state, step=step + 1)
        return state, {"loss": loss, "finite": finite.to(F32)}

    return step_fn


def init_state(params, optimizer: Optimizer, cfg: TrainConfig) -> dict:
    """{"params", "opt", "step"}: ``step`` a 0-d int32 tensor on the
    params' device."""
    _no_compression(cfg)
    device = leaves(params)[0].device
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


@dataclasses.dataclass
class RunReport:
    steps_done: int
    final_loss: float
    restarts: int
    nan_events: int
    straggler_steps: int
    losses: list
    state: dict = None       # final train state
    reslices: int = 0        # elastic re-slices (reslice_fn calls)


def run(state, step_fn: Callable, batch_at: Callable[[int], dict],
        n_steps: int, cfg: TrainConfig,
        ckpt_dir: Optional[str] = None,
        inject_fault_at: Optional[int] = None,
        reslice_fn: Optional[Callable] = None,
        timer: Callable[[], float] = time.monotonic) -> RunReport:
    """Fault-tolerant training loop (single process) up to global step
    ``n_steps``.

    ``batch_at(step)`` must be a pure function of step (resume
    correctness); its numpy arrays are moved to the state's device.
    ``ckpt_dir``: resume from its newest checkpoint, save every
    ``cfg.checkpoint_every`` steps (``keep_last`` kept), restore the newest
    one on a non-finite loss (the batch is skipped) and on a restart (the
    loop rewinds to its step), and save at the end.  Without it a
    non-finite loss only skips its batch (the step's guard kept the state)
    and a restart retries the step.  ``inject_fault_at``: raise a
    simulated node failure at that step once (at most ``cfg.max_restarts``
    restarts in a run).  ``reslice_fn(state, step) -> (state, step_fn)``:
    called after ``cfg.straggler_patience`` consecutive straggler-flagged
    steps, with a just-flushed checkpoint on disk; the loop goes on at the
    same global step.  ``None`` (default) keeps the monitor passive:
    stragglers are only counted.  ``timer``: the clock of the step times,
    injectable so that fault drills drive the straggler EWMA
    deterministically.
    """
    saver = ckpt_lib.AsyncCheckpointer(ckpt_dir, cfg.keep_last) \
        if ckpt_dir else None
    restarts = 0
    nan_events = 0
    straggler_steps = 0
    straggler_run = 0        # consecutive flags since the last quiet step
    reslices = 0
    ewma = None
    warmup = True            # the next measured dt is a warm-up step:
    #   excluded from both the EWMA and the straggler flag
    losses: list = []
    injected = False
    device = state["step"].device

    start = int(state["step"])
    if ckpt_dir:
        restored = ckpt_lib.restore_latest(ckpt_dir, state)
        if restored is not None:
            state, manifest = restored
            start = int(manifest["step"])

    step = start
    while step < n_steps:
        try:
            if inject_fault_at is not None and step == inject_fault_at \
                    and not injected:
                injected = True
                raise RuntimeError("injected node failure")
            t0 = timer()
            batch = {k: torch.as_tensor(np.asarray(v)).to(device)
                     for k, v in batch_at(step).items()}
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = timer() - t0
            if warmup:
                warmup = False
            else:
                if ewma is not None and dt > cfg.straggler_factor * ewma:
                    straggler_steps += 1
                    straggler_run += 1
                else:
                    straggler_run = 0
                ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            saved_this_step = False
            if not np.isfinite(loss):
                nan_events += 1
                if saver:
                    saver.wait()        # never race the in-flight write
                    restored = ckpt_lib.restore_latest(ckpt_dir, state)
                    if restored is not None:
                        state, _ = restored
                warmup = True           # the restore pollutes the next dt
                step += 1               # skip the poisoned batch; a
                #   pending re-slice below must still fire
            else:
                losses.append(loss)
                step += 1
                if saver and step % cfg.checkpoint_every == 0:
                    saver.save(step, state)
                    saved_this_step = True
                    warmup = True       # the save pollutes the next dt
            if reslice_fn is not None \
                    and straggler_run >= cfg.straggler_patience:
                # reset the monitor first: a rebuild that fails (a restart
                # below) must wait for another `patience` flagged steps
                straggler_run = 0
                ewma = None
                warmup = True
                # flush this step's state for the rebuild to restore,
                # unless the boundary save above already holds it
                if saver:
                    if not saved_this_step:
                        saver.save(step, state)
                    saver.wait()
                state, step_fn = reslice_fn(state, step)
                reslices += 1
        except KeyboardInterrupt:
            raise
        except Exception:
            restarts += 1
            if restarts > cfg.max_restarts:
                raise
            if saver:
                try:
                    saver.wait()        # never race the in-flight write
                except Exception:
                    pass                # a failed save is a missing
                    #   snapshot: the restore falls back to the previous
                restored = ckpt_lib.restore_latest(ckpt_dir, state)
                if restored is not None:
                    state, manifest = restored
                    step = int(manifest["step"])
            warmup = True
            # the rewind replays steps: stale consecutive-flag counts and
            # the old timing prior must not leak across the restart
            straggler_run = 0
            ewma = None
            continue
    if saver:
        try:
            saver.save(step, state)
            saver.wait()
        except Exception:
            # as in the loop: the previous atomic snapshot is still valid,
            # and a finished run's report and state matter more
            pass
    return RunReport(steps_done=step - start,
                     final_loss=losses[-1] if losses else float("nan"),
                     restarts=restarts, nan_events=nan_events,
                     straggler_steps=straggler_steps, losses=losses,
                     state=state, reslices=reslices)
