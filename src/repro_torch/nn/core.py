"""Minimal functional NN substrate (PyTorch port of ``repro.nn.core``).

Every layer is a pair of plain functions
    <layer>_init(generator, ..., device) -> params (dict of f32 tensors)
    <layer>_apply(params, x) -> y
Dense weights are stored ``[d_in, d_out]`` and applied as ``x @ w``, the
JAX package's layout, so its parameters load leaf by leaf.  Compute casts
to the input's dtype.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch


def he_uniform(generator: torch.Generator, shape, device,
               fan_in=None) -> torch.Tensor:
    fan_in = fan_in or shape[0]
    lim = float(np.sqrt(6.0 / fan_in))
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return w.uniform_(-lim, lim, generator=generator).to(device)


def normal_init(generator: torch.Generator, shape, device,
                stddev: float = 0.02) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return (w.normal_(generator=generator) * stddev).to(device)


def dense_init(generator: torch.Generator, d_in: int, d_out: int, device,
               bias: bool = True, scale: Optional[float] = None) -> dict:
    """A weight ``[d_in, d_out]``: normal × ``scale`` when a scale is given,
    else He-uniform; a zero bias."""
    w = (normal_init(generator, (d_in, d_out), device, scale)
         if scale is not None else he_uniform(generator, (d_in, d_out),
                                              device))
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=device)
    return p


def dense_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def mlp_init(generator: torch.Generator, dims: Sequence[int], device,
             bias: bool = True) -> list:
    return [dense_init(generator, dims[i], dims[i + 1], device, bias=bias)
            for i in range(len(dims) - 1)]


def bias_epilogue(p: dict, x: torch.Tensor, act: Optional[Callable]) -> bool:
    """Whether the layer ``act(dense_apply(p, x))`` runs as one GEMM whose
    epilogue adds the bias (``torch.addmm``: cuBLASLt's ``BIAS`` epilogue
    on the card), then ``torch.relu``: ``act`` is ``torch.relu``, ``x`` is
    2-D float32, the layer has a float32 bias, and both GEMM widths are
    above 1 (PyTorch's condition for its cuBLASLt path).

    The ReLU stays a pass of its own: cuBLASLt's ``RELU_BIAS`` epilogue
    maps NaN to 0 in some of the kernels it picks for these shapes, where
    ``torch.relu`` keeps NaN, and the train loop's NaN guard relies on
    that."""
    b = p.get("b")
    return (act is torch.relu and b is not None and x.dim() == 2
            and x.dtype == p["w"].dtype == b.dtype == torch.float32
            and min(x.shape) > 1 and p["w"].shape[1] > 1)


def mlp_apply(layers: list, x: torch.Tensor,
              act: Callable = torch.relu,
              final_act: Optional[Callable] = None) -> torch.Tensor:
    """The layers in turn, ``act`` after each but the last and
    ``final_act`` (if any) after the last.  A layer that
    ``bias_epilogue`` admits adds its bias in the GEMM's epilogue."""
    for i, p in enumerate(layers):
        a = act if i < len(layers) - 1 else final_act
        if bias_epilogue(p, x, a):
            x = torch.relu(torch.addmm(p["b"], x, p["w"]))
            continue
        x = dense_apply(p, x)
        if a is not None:
            x = a(x)
    return x


# ---------------------------------------------------------------------------
# norms: f32 statistics, output in the input's dtype
# ---------------------------------------------------------------------------

def layer_norm_init(dim: int, device) -> dict:
    return {"g": torch.ones((dim,), dtype=torch.float32, device=device),
            "b": torch.zeros((dim,), dtype=torch.float32, device=device)}


def layer_norm_apply(p: dict, x: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["g"] + p["b"]).to(x.dtype)


def rms_norm_init(dim: int, device) -> dict:
    return {"g": torch.ones((dim,), dtype=torch.float32, device=device)}


class _RmsNorm(torch.autograd.Function):
    """RMS norm with the JAX package's custom backward (``_rms_bwd``): f32
    internals, ``dx`` returned in ``x``'s dtype and ``dg`` in f32 (so a
    bf16 backward is not autograd of the forward)."""

    @staticmethod
    def forward(ctx, g, x, eps):
        ctx.save_for_backward(g, x)
        ctx.eps = eps
        xf = x.to(torch.float32)
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return (y * g).to(x.dtype)

    @staticmethod
    def backward(ctx, ct):
        g, x = ctx.saved_tensors
        xf = x.to(torch.float32)
        ctf = ct.to(torch.float32)
        ms = (xf * xf).mean(-1, keepdim=True) + ctx.eps
        r = torch.rsqrt(ms)
        dy = ctf * g                       # d/d(normalized x)
        dg = (ctf * (xf * r)).sum(tuple(range(ct.dim() - 1)))
        dx = r * (dy - xf * (dy * xf).mean(-1, keepdim=True) / ms)
        return dg.to(torch.float32), dx.to(x.dtype), None


def rms_norm_apply(p: dict, x: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    return _RmsNorm.apply(p["g"], x, eps)


def batch_norm_init(dim: int, device) -> dict:
    # training-mode BN (batch statistics); GatedGCN benchmark default
    return {"g": torch.ones((dim,), dtype=torch.float32, device=device),
            "b": torch.zeros((dim,), dtype=torch.float32, device=device)}


def batch_norm_apply(p: dict, x: torch.Tensor, eps: float = 1e-5,
                     axes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Normalise over ``axes`` (default: every axis but the last) with the
    batch's own statistics (biased variance)."""
    xf = x.to(torch.float32)
    axes = tuple(range(xf.dim() - 1)) if axes is None else tuple(axes)
    mu = xf.mean(axes, keepdim=True)
    var = xf.var(axes, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["g"] + p["b"]).to(x.dtype)
