"""GatedGCN (Bresson & Laurent; benchmarking-gnns arXiv:2003.00982),
PyTorch port of ``repro.models.gatedgcn`` on one device.

Message passing is built from ``index_add_`` (the JAX package's
``segment_sum``) over an explicit edge-index list:

    ê_ij = C e_ij + D h_i + E h_j                     (edge gate logits)
    η_ij = σ(ê_ij) / (Σ_{j'→i} σ(ê_ij') + ε)          (segment-normalized)
    h_i' = h_i + ReLU(BN(A h_i + Σ_{j→i} η_ij ⊙ B h_j))
    e_ij' = e_ij + ReLU(BN(ê_ij))

Batch layout:
    nodes  [B, N, d_feat]   (B=1 for full-graph cells)
    edges  [B, E, 2] int32  (src, dst), −1-padded

The JAX package maps one graph's layers over the batch (``vmap``); here
the B graphs run at once: node ids are offset by ``g·N`` so every segment
sum is one ``index_add_`` over the whole batch, and each BatchNorm takes
its statistics per graph, as the mapped function does.  Under an active
``repro_torch.dist`` context ``forward`` and ``loss_fn`` raise: the
edge-parallel body is ROADMAP item 7b.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.dist import api as dist
from repro_torch.nn.core import (batch_norm_apply, batch_norm_init,
                                 dense_apply, dense_init, mlp_apply, mlp_init)


@dataclasses.dataclass(frozen=True)
class GatedGCNConfig:
    name: str
    n_layers: int
    d_hidden: int
    d_feat: int
    n_classes: int
    task: str = "node_class"          # "node_class" | "graph_class"
    atom_vocab: int = 0               # molecule cells: categorical features
    compute_dtype: object = torch.float32


def init_params(cfg: GatedGCNConfig, generator: torch.Generator,
                device) -> dict:
    """Random parameters in the JAX package's tree, drawn from
    ``generator`` in the order of its keys."""
    h = cfg.d_hidden
    if cfg.atom_vocab:
        t = torch.empty((cfg.atom_vocab, h), dtype=torch.float32,
                        device=generator.device)
        embed = {"table": (t.normal_(generator=generator) * 0.1).to(device)}
    else:
        embed = dense_init(generator, cfg.d_feat, h, device)
    layers = []
    for _ in range(cfg.n_layers):
        layer = {k: dense_init(generator, h, h, device) for k in "ABCDE"}
        layer["bn_h"] = batch_norm_init(h, device)
        layer["bn_e"] = batch_norm_init(h, device)
        layers.append(layer)
    return {"embed": embed,
            "edge_embed": dense_init(generator, 1, h, device),
            "layers": layers,
            "readout": mlp_init(generator, (h, h // 2, cfg.n_classes),
                                device)}


def _segment_sum(vals: torch.Tensor, seg: torch.Tensor,
                 n: int) -> torch.Tensor:
    """[M, H] rows summed into ``n`` segments by ``seg`` [M] (in
    ``vals``' dtype; in no fixed order on the card)."""
    out = torch.zeros((n,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add(0, seg, vals)


def _bn_edges(p, e_hat: torch.Tensor, emask: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm over each graph's valid edges: masked statistics.
    e_hat [B, E, H], emask [B, E]."""
    w = emask[..., None].to(torch.float32)
    x = e_hat.to(torch.float32) * w
    cnt = w.sum(1, keepdim=True)
    s1 = x.sum(1, keepdim=True)
    s2 = (x * x).sum(1, keepdim=True)
    mu = s1 / torch.clamp_min(cnt, 1.0)
    var = s2 / torch.clamp_min(cnt, 1.0) - mu * mu
    y = (e_hat.to(torch.float32) - mu) * torch.rsqrt(var + eps)
    return (y * p["g"] + p["b"]).to(e_hat.dtype)


def _layer(p, h: torch.Tensor, e: torch.Tensor, src: torch.Tensor,
           dst: torch.Tensor, emask: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One GatedGCN layer on B graphs at once.

    h [B, N, H], e [B, E, H]; src/dst [B·E] int64 node ids already offset
    by graph (g·N + local id; padded edges at their graph's node 0);
    emask [B, E] in h's dtype."""
    bsz, n, hd = h.shape
    n_e = e.shape[1]
    hf = h.reshape(bsz * n, hd)
    hi = hf.index_select(0, src).reshape(bsz, n_e, hd)   # source states
    hj = hf.index_select(0, dst).reshape(bsz, n_e, hd)   # destination
    e_hat = (dense_apply(p["C"], e) + dense_apply(p["D"], hj)
             + dense_apply(p["E"], hi))
    m = emask[..., None]
    sig = torch.sigmoid(e_hat) * m
    # segment-normalised gates over the incoming edges of each dst node
    denom = _segment_sum(sig.reshape(bsz * n_e, hd), dst, bsz * n)
    eta = sig / (denom.index_select(0, dst).reshape(bsz, n_e, hd) + 1e-6)
    msg = eta * dense_apply(p["B"], hi) * m
    agg = _segment_sum(msg.reshape(bsz * n_e, hd), dst,
                       bsz * n).reshape(bsz, n, hd)
    h_new = h + torch.relu(batch_norm_apply(
        p["bn_h"], dense_apply(p["A"], h) + agg, axes=(1,)))
    e_new = e + torch.relu(_bn_edges(p["bn_e"], e_hat, emask))
    return h_new, e_new


def forward(params, cfg: GatedGCNConfig, batch: dict) -> torch.Tensor:
    """-> logits: [B, N, n_classes] (node task) or [B, n_classes] (graph)."""
    if dist.current() is not None:
        raise NotImplementedError(
            "gatedgcn under a mesh: the edge-parallel body is ROADMAP "
            "item 7b")
    nodes = batch["nodes"]
    edges = batch["edges"].long()              # [B, E, 2], -1 padded
    bsz, n, _ = nodes.shape
    n_e = edges.shape[1]

    if cfg.atom_vocab:
        h = params["embed"]["table"][batch["atom_types"].long()]  # [B,N,H]
    else:
        h = dense_apply(params["embed"], nodes.to(cfg.compute_dtype))
    valid = edges[..., 0] >= 0
    off = (torch.arange(bsz, device=edges.device) * n)[:, None]
    src = (torch.where(valid, edges[..., 0], 0) + off).reshape(-1)
    dst = (torch.where(valid, edges[..., 1], 0) + off).reshape(-1)
    e = dense_apply(params["edge_embed"],
                    torch.ones((1, 1), dtype=cfg.compute_dtype,
                               device=nodes.device)).expand(
        bsz, n_e, cfg.d_hidden)
    emask = valid.to(h.dtype)
    for p in params["layers"]:
        h, e = _layer(p, h, e, src, dst, emask)
    if cfg.task == "graph_class":
        nmask = batch.get("node_mask")
        if nmask is None:
            g = h.mean(dim=1)
        else:
            w = nmask.to(h.dtype)[..., None]
            g = (h * w).sum(1) / torch.clamp_min(w.sum(1), 1.0)
        return mlp_apply(params["readout"], g)
    return mlp_apply(params["readout"], h)


def loss_fn(params, cfg: GatedGCNConfig, batch: dict
            ) -> Tuple[torch.Tensor, dict]:
    """Mean cross entropy: over graphs (graph task) or over the nodes that
    ``label_mask`` selects (node task; all nodes without one)."""
    logits = forward(params, cfg, batch)
    labels = batch["labels"].long()
    lse = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    per = lse - gold
    mask = batch.get("label_mask")
    if cfg.task == "graph_class" or mask is None:
        loss = per.mean()
    else:
        w = mask.to(per.dtype)
        loss = (per * w).sum() / torch.clamp_min(w.sum(), 1.0)
    return loss, {"loss": loss}
