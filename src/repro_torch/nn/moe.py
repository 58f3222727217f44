"""Mixture-of-Experts FFN with three dispatch strategies (PyTorch port of
``repro.nn.moe``, plus the one-device grouped dispatch).

* ``moe_apply_dense``: every expert processes every token ([E, N, f])
  and the outputs are gate-combined.  Exact: no capacity drops.
* ``moe_apply_grouped``: the dropless dispatch on one device.  The
  (token, choice) pairs sorted stably by expert, each expert's SwiGLU over
  its own rows only (on the card three grouped GEMMs, ``torch._grouped_mm``,
  fed the experts' row offsets on the card: no count is read on the host),
  the outputs gate-scaled and added back by token.  Its result is the
  dense dispatch's, summed in another order.
* ``moe_apply_ep``: expert parallelism on a ``repro_torch.dist`` mesh.
  Each rank routes its own tokens; the experts live on the ``model``
  axis.  Sort-based fixed-capacity dispatch: top-k -> stable argsort by
  expert -> position in the expert from the counts -> scatter into an
  [E, C, d] buffer (slots past the capacity C dropped) -> ``all_to_all``
  over ``model`` -> the rank's experts' SwiGLU -> the inverse
  ``all_to_all`` -> unsort and gate-combine.  The aux loss is averaged
  over ``aux_axes``.

Routers: ``softmax`` (top-k of the softmax, renormalised) or ``sigmoid``
(DeepSeek-V3's ``noaux_tc`` with one group: top-k of the sigmoid scores
plus a correction bias that selects but does not weight; the gates are
the chosen scores divided by their sum, times ``routed_scale``).

Aux load-balance loss: Switch-style  E · Σ_e f_e · p̄_e, p̄ the router's
per-token probabilities (sigmoid scores normalised per token).

``route_log()`` records the experts every router call chooses while it is
open (off by default, one check a call): a reference can then replay the
same choices and count where its own differ.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import List, Tuple

import torch

from repro_torch.dist import collectives as coll
from repro_torch.dist.api import P
from repro_torch.nn.core import normal_init


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    d_model: int
    d_ff: int                    # per-expert hidden
    n_experts: int
    top_k: int
    n_shared: int = 0            # shared (always-on) experts
    capacity_factor: float = 1.25
    dispatch: str = "dense"      # "dense" | "ep" (grouped on one device)
    router_aux_weight: float = 0.001
    scoring: str = "softmax"     # "softmax" | "sigmoid" (noaux_tc)
    routed_scale: float = 1.0    # the gates' factor (sigmoid routing)


def moe_init(generator: torch.Generator, cfg: MoeConfig, device) -> dict:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {"router": normal_init(generator, (d, e), device, 0.02),
         "w_gate": normal_init(generator, (e, d, f), device, 0.02),
         "w_up": normal_init(generator, (e, d, f), device, 0.02),
         "w_down": normal_init(generator, (e, f, d), device, 0.02)}
    if cfg.n_shared:
        fs = f * cfg.n_shared
        p["shared"] = {"w_gate": normal_init(generator, (d, fs), device,
                                             0.02),
                       "w_up": normal_init(generator, (d, fs), device, 0.02),
                       "w_down": normal_init(generator, (fs, d), device,
                                             0.02)}
    if cfg.scoring == "sigmoid":
        p["score_bias"] = normal_init(generator, (e,), device, 0.02)
    return p


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row, largest first; equal values in index
    order (``jax.lax.top_k``'s rule; ``torch.topk`` promises none)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def expert_counts(idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """The number of entries of ``idx`` (int) naming each of ``n_experts``
    experts, as ``torch.bincount(idx, minlength=n_experts)`` counts them,
    in a tensor whose shape does not depend on the data (so it traces
    under fake tensors)."""
    idx = idx.reshape(-1).long()
    return torch.zeros(n_experts, dtype=torch.int64,
                       device=idx.device).index_add_(0, idx,
                                                     torch.ones_like(idx))


class RouteLog:
    """The experts each router call chose while the log was open, in call
    order: one [N, k] int64 tensor a call, on the device (no copy)."""

    def __init__(self):
        self.idx: List[torch.Tensor] = []


_ROUTES = threading.local()


@contextlib.contextmanager
def route_log():
    """Record, in the calling thread, the expert ids of every router call
    made inside the block; yields the ``RouteLog``."""
    log, prev = RouteLog(), getattr(_ROUTES, "log", None)
    _ROUTES.log = log
    try:
        yield log
    finally:
        _ROUTES.log = prev


def _router(p, cfg: MoeConfig, x: torch.Tensor, ctx=None, axes=()):
    """x [N,d] -> (gates [N,k], idx [N,k], aux loss).
    ``axes``: the aux loss's token statistics summed over the ranks along
    them (each holding its own tokens), as one device over all of them
    would take them."""
    logits = x.to(torch.float32) @ p["router"].to(torch.float32)
    if cfg.scoring == "sigmoid":
        scores = torch.sigmoid(logits)
        _, idx = top_k(scores + p["score_bias"].to(torch.float32),
                       cfg.top_k)
        vals = torch.gather(scores, 1, idx)
        gates = vals / (vals.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scale
        probs = scores / scores.sum(-1, keepdim=True)
    else:
        probs = torch.softmax(logits, dim=-1)
        vals, idx = top_k(probs, cfg.top_k)
        gates = vals / torch.clamp_min(vals.sum(-1, keepdim=True), 1e-9)
    # Switch aux: fraction of tokens per expert × mean router prob per expert
    count = expert_counts(idx[:, 0], cfg.n_experts).to(torch.float32)
    if axes:
        n = idx.shape[0] * ctx.size(axes)
        f_e = coll.all_reduce_(count, ctx, axes) / n
        p_e = coll.all_reduce(probs.sum(0), ctx, axes) / n
    else:
        f_e = count / idx.shape[0]
        p_e = probs.mean(0)
    aux = cfg.n_experts * torch.sum(f_e * p_e)
    log = getattr(_ROUTES, "log", None)
    if log is not None:
        log.idx.append(idx)
    return gates.to(x.dtype), idx, aux


def _swiglu(x, wg, wu, wd):
    h = torch.nn.functional.silu(x @ wg.to(x.dtype)) * (x @ wu.to(x.dtype))
    return h @ wd.to(x.dtype)


def _shared_out(p, x):
    s = p.get("shared")
    if not s:
        return 0.0
    return _swiglu(x, s["w_gate"], s["w_up"], s["w_down"])


def moe_apply_dense(p, cfg: MoeConfig, x: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [N, d] -> ([N, d], aux).  Exact dense compute."""
    n, _ = x.shape
    gates, idx, aux = _router(p, cfg, x)
    h = torch.einsum("nd,edf->enf", x, p["w_gate"].to(x.dtype))
    u = torch.einsum("nd,edf->enf", x, p["w_up"].to(x.dtype))
    y_e = torch.einsum("enf,efd->end", torch.nn.functional.silu(h) * u,
                       p["w_down"].to(x.dtype))
    combine = torch.zeros((n, cfg.n_experts), dtype=x.dtype,
                          device=x.device).scatter_add(1, idx, gates)
    y = torch.einsum("ne,end->nd", combine, y_e)
    return y + _shared_out(p, x), aux


def _expert_swiglu(p, xs: torch.Tensor, counts: torch.Tensor
                   ) -> torch.Tensor:
    """Each expert's SwiGLU over its own rows of ``xs`` [S, d] (sorted by
    expert; ``counts`` [E] rows each) -> [S, d].  On the card one grouped
    GEMM each for gate, up and down, the groups' ends from ``counts`` on
    the card; on the CPU a loop over the experts."""
    wg, wu, wd = (p[k].to(xs.dtype) for k in ("w_gate", "w_up", "w_down"))
    if xs.is_cuda:
        offs = torch.cumsum(counts, 0).to(torch.int32)
        h = torch.nn.functional.silu(torch._grouped_mm(xs, wg, offs=offs)) \
            * torch._grouped_mm(xs, wu, offs=offs)
        return torch._grouped_mm(h, wd, offs=offs)
    outs, start = [], 0
    for e, c in enumerate(counts.tolist()):
        if c:
            outs.append(_swiglu(xs[start:start + c], wg[e], wu[e], wd[e]))
        start += c
    return torch.cat(outs) if outs else xs[:0]


def moe_apply_grouped(p, cfg: MoeConfig, x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [N, d] -> ([N, d], aux): the dropless dispatch on one device.
    The [N·k] (token, choice) pairs sorted stably by expert, their rows
    gathered, each expert's SwiGLU over its rows (``_expert_swiglu``),
    scaled by the gates and added back to their tokens in f32; then the
    shared experts.  No capacity: every pair is computed, so a token's
    output does not depend on the other tokens."""
    n, d = x.shape
    gates, idx, aux = _router(p, cfg, x)
    ea = idx.reshape(-1)
    order = torch.argsort(ea, stable=True)
    tok = order // cfg.top_k
    ys = _expert_swiglu(p, x[tok], expert_counts(ea, cfg.n_experts))
    g = gates.reshape(-1)[order].to(torch.float32)
    out = torch.zeros((n, d), dtype=torch.float32, device=x.device)
    out = out.index_add(0, tok, ys.to(torch.float32) * g[:, None])
    return out.to(x.dtype) + _shared_out(p, x), aux


def capacity(cfg: MoeConfig, n_tokens: int) -> int:
    """The slots of each expert for ``n_tokens`` tokens on a rank:
    max(1, round(n·k / E · capacity_factor)), halves to even (Python's
    ``round``, as the JAX package takes it)."""
    return max(1, int(round(n_tokens * cfg.top_k / cfg.n_experts
                            * cfg.capacity_factor)))


def moe_apply_ep(p, cfg: MoeConfig, x: torch.Tensor, ctx,
                 model_axes=("model",), aux_axes=("model",)
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel dispatch on ``ctx``'s mesh: x [n_loc, d] this
    rank's tokens -> (their outputs [n_loc, d], the aux loss averaged
    over ``aux_axes``).  ``p``'s expert stacks are the rank's block
    [E / M, ...] over ``model_axes`` (M ranks); the router and the shared
    experts are whole.  Slot j of the [N·k] (token, choice) pairs, sorted
    stably by expert, lands at its position within its expert; positions
    past ``capacity`` are dropped (their tokens get no output from that
    expert)."""
    n_loc, d = x.shape
    n_model = ctx.size(model_axes)
    e = cfg.n_experts
    if e % n_model:
        raise ValueError(f"moe_apply_ep: {e} experts do not divide "
                         f"{model_axes} of size {n_model}")
    e_loc = e // n_model
    k = cfg.top_k
    dev = x.device

    gates, idx, aux = _router(p, cfg, x)
    if aux_axes:
        aux = coll.all_reduce(aux, ctx, aux_axes) / ctx.size(aux_axes)

    n_slots = n_loc * k
    cap = capacity(cfg, n_loc)
    ea = idx.reshape(-1)                          # [n_slots] expert of slot
    ga = gates.reshape(-1)
    tok = torch.arange(n_slots, device=dev) // k
    order = torch.argsort(ea, stable=True)
    ea_s, tok_s, ga_s = ea[order], tok[order], ga[order]
    counts = expert_counts(ea, e)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n_slots, device=dev) - starts[ea_s]
    keep = pos < cap

    # a dropped slot writes to one spare row past the E·C slots, which is
    # cut off again: the shapes do not depend on how many slots drop
    dest = torch.where(keep, ea_s * cap + pos,
                       torch.full_like(pos, e * cap))
    send = torch.zeros((e * cap + 1, d), dtype=x.dtype,
                       device=dev).index_put((dest,), x[tok_s])
    send = send[:e * cap].reshape(e, cap, d)
    # recv[i·E_loc + e'] is source rank i's tokens for local expert e'
    recv = coll.all_to_all(send, ctx, model_axes, 0, 0)
    recv = recv.reshape(n_model, e_loc, cap, d).transpose(0, 1).reshape(
        e_loc, n_model * cap, d)
    h = torch.einsum("esd,edf->esf", recv, p["w_gate"].to(x.dtype))
    u = torch.einsum("esd,edf->esf", recv, p["w_up"].to(x.dtype))
    y = torch.einsum("esf,efd->esd", torch.nn.functional.silu(h) * u,
                     p["w_down"].to(x.dtype))
    y = y.reshape(e_loc, n_model, cap, d).transpose(0, 1).reshape(e, cap, d)
    back = coll.all_to_all(y, ctx, model_axes, 0, 0)          # [E, C, d]

    got = back[ea_s, torch.clamp(pos, 0, cap - 1)]
    got = torch.where(keep[:, None], got, torch.zeros((), dtype=got.dtype,
                                                      device=dev))
    out = torch.zeros((n_loc, d), dtype=x.dtype, device=dev).index_add(
        0, tok_s, got * ga_s[:, None])
    return out + _shared_out(p, x), aux


def moe_param_specs(cfg: MoeConfig, rules) -> dict:
    """The layout ``moe_apply_ep`` takes its params in: the expert stacks
    over ``expert``, the router and the shared experts replicated."""
    ex = rules.get("expert")
    p = {"router": P(None, None),
         "w_gate": P(ex, None, None),
         "w_up": P(ex, None, None),
         "w_down": P(ex, None, None)}
    if cfg.n_shared:
        p["shared"] = {"w_gate": P(None, None),
                       "w_up": P(None, None),
                       "w_down": P(None, None)}
    if cfg.scoring == "sigmoid":
        p["score_bias"] = P(None)
    return p
