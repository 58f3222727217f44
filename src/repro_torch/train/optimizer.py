"""Optimizers (PyTorch port of ``repro.train.optimizer``): SGD(+momentum),
Adagrad, Adam/AdamW, Adafactor-lite.  All operate on parameter trees
(``repro_torch.tree``); the moment dtype is configurable.

API:  opt = make_optimizer(cfg);  state = opt.init(params);
      params, state = opt.update(params, grads, state, step)

The state trees have the JAX package's shape (``{"v": tree}``,
``{"m", "v"[, "master"]}``, ``{"f": ...}``), so a JAX optimizer state loads
leaf by leaf through ``convert.params_from_numpy``.  The arithmetic is the
JAX package's, operation for operation, in its dtypes: the learning rate
is a (strongly typed) f32 scalar, so SGD and Adagrad deliver a bf16 param
in f32, as ``jnp`` promotes it.  A grad of ``None`` marks a leaf with no
gradient (the port's counterpart of JAX's float0), and such leaves, like
integer leaves, are frozen.  Updates are pure: they return new tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.tree import leaves, leaves_up_to, tree_map, unflatten

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "adam"            # sgd | adagrad | adam | adamw | adafactor
    lr: float = 1e-3
    momentum: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    moment_dtype: Any = torch.float32   # bf16 halves optimizer memory
    master_weights: bool = False  # f32 master copy for bf16 params
    update_scan_dim0: int = 0     # leaves with shape[0] >= this are updated
    # one dim-0 slice at a time (same numbers; bounds the f32 temporaries)
    grad_clip: float = 0.0
    warmup_steps: int = 0
    decay_steps: int = 0          # 0 = constant after warmup


@dataclasses.dataclass(frozen=True)
class Optimizer:
    cfg: OptimizerConfig
    init: Callable
    update: Callable


def _step_f32(step) -> torch.Tensor:
    s = torch.as_tensor(step)
    return s.to(F32)


def schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """The f32 learning rate at ``step``: linear warmup, then cosine decay
    to 0 at ``decay_steps`` (constant when 0)."""
    s = _step_f32(step)
    lr = torch.full((), cfg.lr, dtype=F32, device=s.device)  # no host copy
    if cfg.warmup_steps:
        lr = lr * torch.clamp_max((s + 1) / cfg.warmup_steps, 1.0)
    if cfg.decay_steps:
        frac = torch.clamp((s - cfg.warmup_steps)
                           / max(1, cfg.decay_steps - cfg.warmup_steps), 0, 1)
        lr = lr * 0.5 * (1 + torch.cos(math.pi * frac))
    return lr


def _clip(grads, max_norm: float):
    if not max_norm:
        return grads
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                        for g in leaves(grads)))
    scale = torch.clamp_max(max_norm / (gn + 1e-9), 1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads)


def _promoted(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``p - x`` with x an f32 update, in the dtype ``jnp`` gives it: bf16
    and f32 params come out f32."""
    dt = torch.promote_types(p.dtype, F32)
    return p.to(dt) - x.to(dt)


def _frozen_aware(update: Callable) -> Callable:
    """Make an optimizer update tolerate leaves it must not change.

    Integer leaves (``qrobe``'s int8 codes) and leaves whose grad is None
    are *frozen*: the inner update sees f32 zeros for both, and the
    original leaf is restored on the way out.  When every leaf is an
    ordinary float with a grad, the update runs as it is.
    """
    def wrapped(params, grads, state, step):
        flat_p = leaves(params)
        flat_g = leaves_up_to(params, grads)
        frozen = [not p.is_floating_point() or g is None
                  for p, g in zip(flat_p, flat_g)]
        if not any(frozen):
            return update(params, grads, state, step)
        z = [torch.zeros(p.shape, dtype=F32, device=p.device) if f else None
             for p, f in zip(flat_p, frozen)]
        sub_p = unflatten(params, [zz if f else p
                                   for p, f, zz in zip(flat_p, frozen, z)])
        sub_g = unflatten(params, [zz if f else g
                                   for g, f, zz in zip(flat_g, frozen, z)])
        new_p, new_s = update(sub_p, sub_g, state, step)
        out = [p if f else np_ for p, np_, f
               in zip(flat_p, leaves_up_to(params, new_p), frozen)]
        return unflatten(params, out), new_s
    return wrapped


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    k = cfg.kind
    mdt = cfg.moment_dtype

    if k == "sgd":
        def init(params):
            if cfg.momentum:
                return {"m": tree_map(
                    lambda p: torch.zeros_like(p, dtype=mdt), params)}
            return {}

        def update(params, grads, state, step):
            grads = _clip(grads, cfg.grad_clip)
            lr = schedule(cfg, step)
            if cfg.momentum:
                m = tree_map(
                    lambda mm, g: (cfg.momentum * mm.to(F32)
                                   + g.to(F32)).to(mdt),
                    state["m"], grads)
                params = tree_map(
                    lambda p, mm: _promoted(p, lr * mm.to(p.dtype).to(F32)),
                    params, m)
                return params, {"m": m}
            params = tree_map(
                lambda p, g: _promoted(p, lr * g.to(p.dtype).to(F32)),
                params, grads)
            return params, state
        return Optimizer(cfg, init, _frozen_aware(update))

    if k == "adagrad":
        def init(params):
            return {"v": tree_map(lambda p: torch.zeros_like(p, dtype=mdt),
                                  params)}

        def update(params, grads, state, step):
            grads = _clip(grads, cfg.grad_clip)
            lr = schedule(cfg, step)
            v = tree_map(
                lambda vv, g: (vv.to(F32) + torch.square(g.to(F32))).to(mdt),
                state["v"], grads)
            params = tree_map(
                lambda p, g, vv: _promoted(
                    p, lr * g.to(F32) / (torch.sqrt(vv.to(F32)) + cfg.eps)),
                params, grads, v)
            return params, {"v": v}
        return Optimizer(cfg, init, _frozen_aware(update))

    if k in ("adam", "adamw"):
        def init(params):
            z = lambda p: torch.zeros_like(p, dtype=mdt)
            st = {"m": tree_map(z, params), "v": tree_map(z, params)}
            if cfg.master_weights:
                st["master"] = tree_map(lambda p: p.to(F32), params)
            return st

        def update(params, grads, state, step):
            grads = _clip(grads, cfg.grad_clip)
            lr = schedule(cfg, step)
            t = _step_f32(step) + 1
            bc1 = 1 - torch.pow(cfg.beta1, t)
            bc2 = 1 - torch.pow(cfg.beta2, t)
            base = state.get("master", params)

            def one(p0, g, mm, vv):
                mf = (cfg.beta1 * mm.to(F32)
                      + (1 - cfg.beta1) * g.to(F32))
                vf = (cfg.beta2 * vv.to(F32)
                      + (1 - cfg.beta2) * torch.square(g.to(F32)))
                d = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
                if k == "adamw" and cfg.weight_decay:
                    d = d + cfg.weight_decay * p0.to(F32)
                nm = (p0.to(F32) - lr * d).to(p0.dtype)
                return nm, mf.to(mdt), vf.to(mdt)

            def leaf(p0, g, mm, vv):
                if cfg.update_scan_dim0 and p0.dim() >= 2 \
                        and p0.shape[0] >= cfg.update_scan_dim0:
                    # one dim-0 slice at a time: the f32 temporaries are
                    # bounded to a slice, the numbers are the same
                    outs = [one(p0[i], g[i], mm[i], vv[i])
                            for i in range(p0.shape[0])]
                    return tuple(torch.stack(o) for o in zip(*outs))
                return one(p0, g, mm, vv)

            out = [leaf(*xs) for xs in zip(
                leaves(base), leaves_up_to(base, grads),
                leaves_up_to(base, state["m"]),
                leaves_up_to(base, state["v"]))]
            new_master = unflatten(base, [o[0] for o in out])
            m = unflatten(base, [o[1] for o in out])
            v = unflatten(base, [o[2] for o in out])
            new_params = tree_map(lambda nm, p: nm.to(p.dtype), new_master,
                                  params)
            st = {"m": m, "v": v}
            if cfg.master_weights:
                st["master"] = new_master
            return new_params, st
        return Optimizer(cfg, init, _frozen_aware(update))

    if k == "adafactor":
        # factored second moment (rows/cols) for >=2D params; first moment
        # off
        def init(params):
            def st(p):
                if p.dim() >= 2:
                    return {"vr": torch.zeros(p.shape[:-1], dtype=F32,
                                              device=p.device),
                            "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                              dtype=F32, device=p.device)}
                return {"v": torch.zeros_like(p, dtype=F32)}
            return {"f": unflatten(params, [st(p) for p in leaves(params)])}

        def update(params, grads, state, step):
            grads = _clip(grads, cfg.grad_clip)
            lr = schedule(cfg, step)
            b2 = 1.0 - (_step_f32(step) + 1) ** -0.8

            def upd(p, g, s):
                g = g.to(F32)
                if p.dim() >= 2:
                    vr = b2 * s["vr"] + (1 - b2) * torch.mean(g * g, -1)
                    vc = b2 * s["vc"] + (1 - b2) * torch.mean(g * g, -2)
                    r = vr / torch.clamp_min(
                        torch.mean(vr, -1, keepdim=True), 1e-30)
                    d = g / (torch.sqrt(r)[..., None]
                             * torch.sqrt(vc)[..., None, :] + cfg.eps)
                    return ((p.to(F32) - lr * d).to(p.dtype),
                            {"vr": vr, "vc": vc})
                v = b2 * s["v"] + (1 - b2) * g * g
                return ((p.to(F32) - lr * g / (torch.sqrt(v) + cfg.eps)
                         ).to(p.dtype), {"v": v})

            out = [upd(p, g, s) for p, g, s in zip(
                leaves(params), leaves_up_to(params, grads),
                leaves_up_to(params, state["f"]))]
            return (unflatten(params, [o[0] for o in out]),
                    {"f": unflatten(params, [o[1] for o in out])})
        return Optimizer(cfg, init, _frozen_aware(update))

    raise ValueError(f"unknown optimizer {k}")
