"""Mixture-of-Experts FFN, dense dispatch (PyTorch port of
``repro.nn.moe``'s one-device path).

``moe_apply_dense``: every expert processes every token ([E, N, f]) and
the outputs are gate-combined.  Exact: no capacity drops.  The expert-
parallel dispatch of the JAX package (``moe_apply_ep``, an all_to_all
over the ``model`` axis) waits for the mesh port of the LM family.

Aux load-balance loss: Switch-style  E · Σ_e f_e · p̄_e.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.nn.core import normal_init


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    d_model: int
    d_ff: int                    # per-expert hidden
    n_experts: int
    top_k: int
    n_shared: int = 0            # shared (always-on) experts
    capacity_factor: float = 1.25
    dispatch: str = "dense"      # "dense" | "ep" (ep: not on one device)
    router_aux_weight: float = 0.001


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
    return p


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row, largest first; equal values in index
    order (``jax.lax.top_k``'s rule; ``torch.topk`` promises none)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(p, cfg: MoeConfig, x: torch.Tensor):
    """x [N,d] -> (gates [N,k] renormalised, idx [N,k], aux loss)."""
    logits = x.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = top_k(probs, cfg.top_k)
    gates = vals / torch.clamp_min(vals.sum(-1, keepdim=True), 1e-9)
    # Switch aux: fraction of tokens per expert × mean router prob per expert
    f_e = torch.bincount(idx[:, 0], minlength=cfg.n_experts).to(
        torch.float32) / idx.shape[0]
    p_e = probs.mean(0)
    aux = cfg.n_experts * torch.sum(f_e * p_e)
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
