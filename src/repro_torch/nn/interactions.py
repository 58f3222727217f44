"""Feature interactions for the recsys family (PyTorch port of
``repro.nn.interactions``).

dot (DLRM, a Hopper kernel), FM (DeepFM), CIN (xDeepFM), cross network
(DCN), SENET + bilinear (FiBiNET), multi-head self-attention over fields
(AutoInt).  All take field embeddings [B, F, D].  Every one but the dot
interaction is plain PyTorch, as it is ``jnp`` in the JAX package, and
autograd gives its backward.  Inits draw from one ``torch.Generator`` in
the order of the JAX package's keys and keep its parameter tree.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.ops import dot_interaction
from repro_torch.nn.core import dense_apply, dense_init, normal_init

#: bytes the CIN's outer product z of one chunk of the batch may take:
#: xDeepFM's widest layer (F0 = 39, Fk = 200, D = 10) is 312 KB a sample,
#: so a chunk is 6,410 samples
CIN_CHUNK_BYTES = 2_000_000_000


# ---------------------------------------------------------------------------
# FM second-order term (DeepFM): ½((Σv)² − Σv²) summed over dim
# ---------------------------------------------------------------------------

def fm_interaction(feats: torch.Tensor) -> torch.Tensor:
    s = feats.sum(dim=1)                     # [B, D]
    s2 = (feats * feats).sum(dim=1)          # [B, D]
    return 0.5 * (s * s - s2).sum(dim=-1, keepdim=True)     # [B, 1]


# ---------------------------------------------------------------------------
# DCN cross network: x_{l+1} = x0 * (W x_l + b) + x_l
# ---------------------------------------------------------------------------

def cross_net_init(generator: torch.Generator, dim: int, n_layers: int,
                   device) -> list:
    return [dense_init(generator, dim, dim, device, bias=True, scale=0.01)
            for _ in range(n_layers)]


def cross_net_apply(layers: list, x0: torch.Tensor) -> torch.Tensor:
    x = x0
    for p in layers:
        x = x0 * dense_apply(p, x) + x
    return x


# ---------------------------------------------------------------------------
# xDeepFM CIN: x^k[b,h,d] = Σ_ij W^k[h,i,j] x0[b,i,d] x^{k-1}[b,j,d]
# ---------------------------------------------------------------------------

def cin_init(generator: torch.Generator, n_fields: int,
             layer_sizes: Sequence[int], device) -> list:
    params = []
    prev = n_fields
    for h in layer_sizes:
        params.append({"w": normal_init(generator, (h, n_fields, prev),
                                        device, 0.01)})
        prev = h
    return params


def cin_chunk(f0: int, fk: int, d: int, itemsize: int) -> int:
    """Samples of a chunk whose z [F0, Fk, b, D] fits CIN_CHUNK_BYTES."""
    return max(1, CIN_CHUNK_BYTES // (f0 * fk * d * itemsize))


def _cin_chunk_fm(x0: torch.Tensor, xk: torch.Tensor, w2: torch.Tensor
                  ) -> torch.Tensor:
    f0, b, d = x0.shape
    z = (x0[:, None] * xk[None]).reshape(f0 * xk.shape[0], b * d)
    return (w2 @ z).view(w2.shape[0], b, d)


def _cin_layer_fm(x0: torch.Tensor, xk: torch.Tensor, w: torch.Tensor
                  ) -> torch.Tensor:
    """One CIN layer on field-major operands: x0 [F0, B, D], xk [Fk, B, D]
    -> [H, B, D].

    Left to right, a three-operand einsum would build z [B, F0, Fk, D]
    whole (20 GB at xDeepFM's width and B = 65,536).  Here z is formed a
    chunk of the batch at a time, as [F0·Fk, b·D], so each chunk is one
    GEMM of w [H, F0·Fk] against it.  Under autograd each chunk is
    recomputed in the backward (``torch.utils.checkpoint``), so the saved
    z never exceeds one chunk either.
    """
    f0, b, d = x0.shape
    w2 = w.reshape(w.shape[0], -1).to(x0.dtype)
    chunk = cin_chunk(f0, xk.shape[0], d, x0.element_size())
    grad = torch.is_grad_enabled() and (
        x0.requires_grad or xk.requires_grad or w2.requires_grad)
    outs = []
    for s in range(0, b, chunk):
        a, c = x0[:, s:s + chunk], xk[:, s:s + chunk]
        outs.append(checkpoint(_cin_chunk_fm, a, c, w2, use_reentrant=False)
                    if grad else _cin_chunk_fm(a, c, w2))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def cin_layer(x0: torch.Tensor, xk: torch.Tensor, w: torch.Tensor
              ) -> torch.Tensor:
    """x0 [B, F0, D], xk [B, Fk, D], w [H, F0, Fk] -> [B, H, D], as
    ``kernels.ref.cin_layer_ref``, as many samples at a time as
    ``CIN_CHUNK_BYTES`` allows."""
    return _cin_layer_fm(x0.transpose(0, 1), xk.transpose(0, 1),
                         w).transpose(0, 1)


def cin_apply(params: list, x0: torch.Tensor) -> torch.Tensor:
    """x0 [B, F, D] -> [B, Σ_k H_k] (sum-pooled feature maps)."""
    x0 = x0.transpose(0, 1)                  # field-major for every layer
    xk = x0
    pooled = []
    for p in params:
        xk = _cin_layer_fm(x0, xk, p["w"])
        pooled.append(xk.sum(dim=-1))        # [H, B]
    return torch.cat(pooled, dim=0).t()


# ---------------------------------------------------------------------------
# FiBiNET: SENET field re-weighting + bilinear interaction
# ---------------------------------------------------------------------------

def senet_init(generator: torch.Generator, n_fields: int, device,
               reduction: int = 3) -> dict:
    mid = max(1, n_fields // reduction)
    return {"w1": dense_init(generator, n_fields, mid, device, bias=False),
            "w2": dense_init(generator, mid, n_fields, device, bias=False)}


def senet_apply(p: dict, feats: torch.Tensor) -> torch.Tensor:
    z = feats.mean(dim=-1)                             # [B, F]
    a = torch.relu(dense_apply(p["w1"], z))
    a = torch.relu(dense_apply(p["w2"], a))            # [B, F]
    return feats * a[..., None]


def bilinear_init(generator: torch.Generator, n_fields: int, dim: int,
                  device) -> dict:
    # "field-all" bilinear: one shared [D, D]
    return {"w": normal_init(generator, (dim, dim), device, 0.01)}


def bilinear_apply(p: dict, feats: torch.Tensor) -> torch.Tensor:
    b, f, _ = feats.shape
    left = feats @ p["w"].to(feats.dtype)              # [B, F, D]
    # row-major strict lower triangle, as jnp.tril_indices(f, k=-1)
    i, j = torch.tril_indices(f, f, offset=-1, device=feats.device)
    return (left[:, i, :] * feats[:, j, :]).reshape(b, -1)


# ---------------------------------------------------------------------------
# AutoInt interacting layer: MHSA over fields with residual
# ---------------------------------------------------------------------------

def autoint_layer_init(generator: torch.Generator, d_in: int, d_attn: int,
                       n_heads: int, device) -> dict:
    d_h = d_attn * n_heads
    return {name: dense_init(generator, d_in, d_h, device, bias=False)
            for name in ("wq", "wk", "wv", "wr")}     # wr: residual proj


def autoint_layer_apply(p: dict, x: torch.Tensor, n_heads: int
                        ) -> torch.Tensor:
    b, f, _ = x.shape

    def split(t):
        return t.reshape(b, f, n_heads, -1).permute(0, 2, 1, 3)
    q, k, v = (split(dense_apply(p[n], x)) for n in ("wq", "wk", "wv"))
    att = torch.softmax(torch.einsum("bhfd,bhgd->bhfg", q, k), dim=-1)
    o = torch.einsum("bhfg,bhgd->bhfd", att, v).permute(0, 2, 1, 3
                                                        ).reshape(b, f, -1)
    return torch.relu(o + dense_apply(p["wr"], x))


def dot_interaction_op(feats: torch.Tensor, self_interaction: bool = False
                       ) -> torch.Tensor:
    return dot_interaction(feats, self_interaction)
