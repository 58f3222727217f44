"""Train-step builder + fault-tolerant runner (PyTorch port of
``repro.train.train_loop``).

``build_train_step`` returns one function:
    state, metrics = step_fn(state, batch)
with gradient accumulation (microbatches in a Python loop, where the JAX
package scans), the NaN guard and the optional post-update ``project``
hook.  PyTorch runs it eagerly: nothing is compiled, and on the card the
DLRM's sparse work runs in the Hopper kernels of ``kernels/ops.py``,
forward and backward.

Under a ``repro_torch.dist`` context every rank runs the step on the same
global batch, holding its shards of the state by ``specs`` (the live
param spec tree).  The step applies ``dist.api``'s gradient rule in one
place: each leaf's gradient of the rank's own mean loss is summed over
the mesh axes the leaf is replicated over and scaled by 1/n; with
``grad_compression`` (``bf16`` | ``int8``) the data axes' sum instead goes
through ``compressed_psum`` with error feedback (``state["ef"]``: the
rank's [1, ...] slice of the JAX package's [n_dp, ...] residuals).  The
NaN guard's flag is agreed by an all-reduce MIN.

``run`` is the production loop: a checkpoint every k steps (async,
atomic, ``train/checkpoint.py``), resume from the newest one, NaN ->
restore + skip the batch, straggler monitor (step-time EWMA, warm-up
aware), elastic re-slice hook, injected faults and bounded restarts that
rewind to the newest checkpoint, with an injectable clock.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.dist import api as dist
from repro_torch.dist import collectives as coll
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.compression import compressed_psum
from repro_torch.train.optimizer import F32, Optimizer
from repro_torch.tree import leaves, leaves_up_to, tree_map, unflatten


@dataclasses.dataclass
class TrainConfig:
    grad_accum: int = 1
    checkpoint_every: int = 100
    keep_last: int = 3
    max_restarts: int = 3
    log_every: int = 10
    grad_compression: str = "none"       # none | bf16 | int8
    straggler_factor: float = 3.0        # step > f × EWMA ⇒ flagged
    straggler_patience: int = 3          # consecutive flags ⇒ re-slice
    #   (only with a reslice_fn; the EWMA skips warm-up steps -- the first
    #   step, and the step after a restore, a restart, a checkpoint save or
    #   a re-slice)


_COMPRESSION = ("none", "bf16", "int8")


def _check(cfg: TrainConfig) -> None:
    if cfg.grad_compression not in _COMPRESSION:
        raise ValueError(f"unknown compression {cfg.grad_compression!r}")


def _leaf_specs(params, specs) -> list:
    """The ``P`` of each leaf of ``params`` (None: replicated)."""
    if specs is None:
        return [None] * len(leaves(params))
    return leaves_up_to(params, specs)


def _sharded_axes(spec) -> tuple:
    return tuple(a for e in (spec or ()) for a in dist.axes_tuple(e))


def mesh_grads(ctx, grads: list, specs: list, method: str = "none",
               residual: Optional[list] = None):
    """The gradient rule (``dist.api`` contract point 4) on the flat
    gradients of the rank's own mean loss: (global gradients of the
    rank's shards, new residuals).

    ``none``: each leaf summed over the mesh axes it is replicated over,
    then scaled by 1/n.  ``bf16`` / ``int8``: each data shard's gradient
    first (summed exactly over the other axes, a sharded leaf gathered
    whole, scaled by 1 / their size), then the data axes' mean through
    ``compressed_psum`` with the residuals, then the rank's shard cut
    again.  A leaf sharded over a data axis (``full`` ``2d``) has no
    data-axis all-reduce to compress and raises.
    """
    names = tuple(ctx.mesh.axis_names)
    if method == "none":
        out = []
        for g, s in zip(grads, specs):
            if g is not None:
                rep = tuple(a for a in names if a not in _sharded_axes(s))
                if rep:
                    g = coll.all_reduce_(g.contiguous(), ctx, rep)
                g = g / ctx.n_devices
            out.append(g)
        return out, residual
    dp = ctx.dp_axes
    rest = tuple(a for a in names if a not in dp)
    live = [i for i, g in enumerate(grads) if g is not None]
    full = []
    for i in live:
        g, s = grads[i], specs[i]
        sharded = _sharded_axes(s)
        if set(sharded) & set(dp):
            raise ValueError(f"grad_compression compresses the data-axis "
                             f"all-reduce; a leaf sharded over {sharded} "
                             f"has none")
        rep = tuple(a for a in rest if a not in sharded)
        if rep:
            g = coll.all_reduce_(g.contiguous(), ctx, rep)
        if sharded:
            g = dist.Sharding(ctx, s).gather(g)
        full.append(g / ctx.size(rest))
    res = None if residual is None else [residual[i] for i in live]
    red, new_res = compressed_psum(full, res, dp, method, ctx)
    out = list(grads)
    for k, i in enumerate(live):
        out[i] = red[k] if specs[i] is None else \
            dist.Sharding(ctx, specs[i]).cut(red[k])
    residual = list(residual) if residual is not None else [None] * len(
        grads)
    for k, i in enumerate(live):
        residual[i] = new_res[k]
    return out, residual


def _check_optimizer(optimizer: Optimizer, specs: list) -> None:
    """The optimizers whose update reads more than a leaf's own elements
    (global-norm clipping, Adafactor's factored moments) would need that
    sum across shards too."""
    if any(_sharded_axes(s) for s in specs) and (
            optimizer.cfg.grad_clip or optimizer.cfg.kind == "adafactor"):
        raise ValueError("grad_clip and adafactor read whole leaves: shard "
                         "no leaf under them")


def build_train_step(loss_fn: Callable, optimizer: Optimizer,
                     cfg: TrainConfig,
                     project: Optional[Callable] = None,
                     specs=None) -> Callable:
    """loss_fn(params, batch) -> (loss, metrics dict of scalars).

    Gradients come from ``torch.autograd.grad`` over the float leaves of
    the params; integer leaves get no gradient (None) and the optimizer
    freezes them.  ``project`` (optional) is applied to the params after
    every update (the quantized substrates' requantization hook; see
    ``models.recsys.make_project_fn``).  The NaN guard keeps the old params
    and optimizer state, leaf by leaf with ``torch.where`` on a flag that
    stays on the device, when the loss or any grad is not finite.

    ``specs``: the params' live ``P`` tree (pruned to the mesh), needed
    when the step runs under a ``repro_torch.dist`` context.  The step
    hands it to the lookups (``dist.placed``) and carries it as
    ``step_fn.param_specs`` (``run`` checkpoints the state's shards by
    it).
    """
    _check(cfg)
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
        ctx = dist.current()
        if cfg.grad_compression != "none" and ctx is None:
            raise ValueError("grad_compression needs a mesh: run the step "
                             "under dist.use(ctx)")
        if ctx is not None and specs is None:
            raise ValueError("a step under a mesh needs specs=, the params' "
                             "live P tree (replicated_specs for pure data "
                             "parallelism)")
        with dist.placed(specs):
            loss, flat_g = grads_of(params, batch)
        with torch.no_grad():
            if ctx is not None:
                flat_s = _leaf_specs(params, specs)
                _check_optimizer(optimizer, flat_s)
                ef = state.get("ef")
                flat_r = None if ef is None else [
                    None if r is None else r[0] for r in leaves(ef)]
                flat_g, flat_r = mesh_grads(ctx, flat_g, flat_s,
                                            cfg.grad_compression, flat_r)
                if ef is not None:
                    state = dict(state, ef=unflatten(ef, [
                        None if r is None else r[None] for r in flat_r]))
            finite = torch.isfinite(loss)
            for g in flat_g:
                if g is not None:
                    finite &= torch.all(torch.isfinite(g))
            if ctx is not None:
                # every rank must take the same branch of the guard
                finite = coll.agree_all(finite, ctx)
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

    step_fn.param_specs = specs
    return step_fn


def init_state(params, optimizer: Optimizer, cfg: TrainConfig,
               specs=None) -> dict:
    """{"params", "opt", "step"}: ``step`` a 0-d int32 tensor on the
    params' device.  With ``grad_compression``, also ``"ef"``: the error
    feedback residuals, f32 zeros of [1, *global leaf shape] per float
    leaf (the rank's slice of [n_dp, ...]; ``specs``, the params' live
    ``P`` tree, gives a sharded leaf's global shape)."""
    _check(cfg)
    device = leaves(params)[0].device
    state = {"params": params, "opt": optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.grad_compression != "none":
        ctx = dist.current()
        shapes = [tuple(p.shape) for p in leaves(params)]
        if ctx is not None and specs is not None:
            shapes = [tuple(p.shape) if s is None else
                      dist.Sharding(ctx, s).global_shape(p.shape)
                      for p, s in zip(leaves(params),
                                      _leaf_specs(params, specs))]
        state["ef"] = unflatten(params, [
            torch.zeros((1,) + shape, dtype=F32, device=device)
            for shape in shapes])
    return state


def _live_shardings(state, step_fn):
    """The state's shardings on the current mesh, from the step's live
    param specs (None outside a context): checkpoints gather by them and
    restores cut by them -- after a re-slice, onto the survivors."""
    ctx = dist.current()
    if ctx is None:
        return None
    from repro_torch.train.elastic import train_state_specs
    pspecs = getattr(step_fn, "param_specs", None)
    if pspecs is None:
        raise ValueError("run under a mesh needs a step from "
                         "build_train_step(..., specs=)")
    return dist.named_shardings(ctx, train_state_specs(state, pspecs,
                                                       ctx.rules))


def _agreed(err, key: int):
    """``err`` as every rank of the active mesh sees it (no mesh: as it
    is): one rank's failure restarts every rank."""
    ctx = dist.current()
    return err if ctx is None else coll.agree_failure(err, ctx, key)


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
    left_at: Optional[int] = None   # the re-slice step at which this rank
    #   left the mesh (None: it trained to the end)


def run(state, step_fn: Callable, batch_at: Callable[[int], dict],
        n_steps: int, cfg: TrainConfig,
        ckpt_dir: Optional[str] = None,
        inject_fault_at: Optional[int] = None,
        reslice_fn: Optional[Callable] = None,
        timer: Callable[[], float] = time.monotonic) -> RunReport:
    """Fault-tolerant training loop up to global step ``n_steps``.

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

    Under a ``repro_torch.dist`` context every rank runs the loop on the
    same global batches, with ``step_fn`` from ``build_train_step(...,
    specs=)``: checkpoints gather the state's shards and rank 0 writes
    them, restores cut the global leaves by the live specs, and the
    re-slice trigger is agreed by an all-reduce MAX, so that every rank
    takes it at the same step.  So is a failure: each rank catches its
    own, and every rank reaches one agreement (``agree_failure``) before
    the step's collectives, one after the step and its save, and one
    after a re-slice, then all restart together, at the same step (a
    checkpoint write that fails on rank 0 raises on every rank's
    ``wait``).  A failure inside the step's own collectives on one rank
    only (an out-of-memory on one card) cannot be agreed: the others wait
    in that collective until the process group's timeout raises there,
    and the run ends in an error on every rank.  Here a loop per rank
    also differs from the JAX package's single controller: a rank that
    the re-slice drops (``reslice_fn`` hands it back no step function)
    leaves the loop at the re-slice step, with ``left_at`` set and no
    final save.
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
    left_at = None
    if ckpt_dir:
        restored = ckpt_lib.restore_latest(
            ckpt_dir, state, shardings=_live_shardings(state, step_fn))
        if restored is not None:
            state, manifest = restored
            start = int(manifest["step"])

    step = start
    while step < n_steps:
        at, err, trip = step, None, False
        try:
            if inject_fault_at is not None and step == inject_fault_at \
                    and not injected:
                injected = True
                raise RuntimeError("injected node failure")
            t0 = timer()
            batch = {k: torch.as_tensor(np.asarray(v)).to(device)
                     for k, v in batch_at(step).items()}
        except Exception as e:
            err = e
        # under a mesh, every rank acts on one outcome, agreed at fixed
        # points of the iteration: before the step's collectives, after
        # the step and its save, and after a re-slice
        err = _agreed(err, 3 * at)
        if err is None:
            try:
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
                        restored = ckpt_lib.restore_latest(
                            ckpt_dir, state,
                            shardings=_live_shardings(state, step_fn))
                        if restored is not None:
                            state, _ = restored
                    warmup = True           # the restore pollutes the next dt
                    step += 1               # skip the poisoned batch; a
                    #   pending re-slice below must still fire
                else:
                    losses.append(loss)
                    step += 1
                    if saver and step % cfg.checkpoint_every == 0:
                        saver.save(step, state,
                                   shardings=_live_shardings(state, step_fn))
                        saved_this_step = True
                        warmup = True       # the save pollutes the next dt
                trip = straggler_run >= cfg.straggler_patience
            except Exception as e:
                err = e
            err = _agreed(err, 3 * at + 1)
            if err is None and reslice_fn is not None \
                    and dist.current() is not None:
                # one rank's straggler trips every rank's re-slice
                trip = bool(coll.agree_any(trip, dist.current()))
        if err is None and reslice_fn is not None and trip:
            try:
                # reset the monitor first: a rebuild that fails (a restart
                # below) must wait for another `patience` flagged steps
                straggler_run = 0
                ewma = None
                warmup = True
                # flush this step's state for the rebuild to restore,
                # unless the boundary save above already holds it
                if saver:
                    if not saved_this_step:
                        saver.save(step, state,
                                   shardings=_live_shardings(state, step_fn))
                    saver.wait()
                state, step_fn = reslice_fn(state, step)
                reslices += 1
                if step_fn is None:     # this rank left the mesh
                    left_at = step
                    break
            except Exception as e:
                err = e
            err = _agreed(err, 3 * at + 2)
        if err is None:
            continue
        restarts += 1
        if restarts > cfg.max_restarts:
            raise err
        if saver:
            try:
                saver.wait()        # never race the in-flight write
            except Exception:
                pass                # a failed save is a missing
                #   snapshot: the restore falls back to the previous
            restored = ckpt_lib.restore_latest(
                ckpt_dir, state, shardings=_live_shardings(state, step_fn))
            if restored is not None:
                state, manifest = restored
                step = int(manifest["step"])
        warmup = True
        # the rewind replays steps: stale consecutive-flag counts and the
        # old timing prior must not leak across the restart
        straggler_run = 0
        ewma = None
    if saver and left_at is None:
        try:
            saver.save(step, state,
                       shardings=_live_shardings(state, step_fn))
            saver.wait()
        except Exception:
            # as in the loop: the previous atomic snapshot is still valid,
            # and a finished run's report and state matter more
            pass
    return RunReport(steps_done=step - start,
                     final_loss=losses[-1] if losses else float("nan"),
                     restarts=restarts, nan_events=nan_events,
                     straggler_steps=straggler_steps, losses=losses,
                     state=state, reslices=reslices, left_at=left_at)
