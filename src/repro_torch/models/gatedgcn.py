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
its statistics per graph, as the mapped function does.

Under an active ``repro_torch.dist`` context (``dist.api``'s contract:
the global batch in, global logits and the global mean loss out):

* one graph of at least ``EDGE_PARALLEL_MIN`` edges runs edge-parallel,
  as the JAX package's ``shard_map`` body: the edges are cut into one
  block a rank over the whole mesh, in the mesh's linear order; the node
  state stays whole on every rank, and the per-layer segment sums
  (``denom``, ``agg``) and the edge BatchNorm's ``cnt``/``s1``/``s2`` are
  summed over the mesh (the differentiable ``collectives.all_reduce``).
  An edge count that does not divide the mesh raises ``ValueError``, as
  ``shard_map`` refuses an argument whose sharded dim does not divide;
* any other batch runs data-parallel: each rank takes its graphs
  (``dist.batch_rows``; every graph when the batch does not divide).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.dist import api as dist
from repro_torch.dist import collectives as coll
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


#: the fewest edges of one graph that run edge-parallel under a mesh
EDGE_PARALLEL_MIN = 4096


def _psum(x: torch.Tensor, ctx) -> torch.Tensor:
    """``x`` summed over the whole mesh (``ctx``; None: as it is)."""
    if ctx is None:
        return x
    return coll.all_reduce(x, ctx, tuple(ctx.mesh.axis_names))


def _bn_edges(p, e_hat: torch.Tensor, emask: torch.Tensor,
              eps: float = 1e-5, ctx=None) -> torch.Tensor:
    """BatchNorm over each graph's valid edges: masked statistics (with
    ``ctx``, of the edges of every rank).  e_hat [B, E, H], emask [B, E]."""
    w = emask[..., None].to(torch.float32)
    x = e_hat.to(torch.float32) * w
    cnt = _psum(w.sum(1, keepdim=True), ctx)
    s1 = _psum(x.sum(1, keepdim=True), ctx)
    s2 = _psum((x * x).sum(1, keepdim=True), ctx)
    mu = s1 / torch.clamp_min(cnt, 1.0)
    var = s2 / torch.clamp_min(cnt, 1.0) - mu * mu
    y = (e_hat.to(torch.float32) - mu) * torch.rsqrt(var + eps)
    return (y * p["g"] + p["b"]).to(e_hat.dtype)


def _layer(p, h: torch.Tensor, e: torch.Tensor, src: torch.Tensor,
           dst: torch.Tensor, emask: torch.Tensor, ctx=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One GatedGCN layer on B graphs at once.

    h [B, N, H], e [B, E, H]; src/dst [B·E] int64 node ids already offset
    by graph (g·N + local id; padded edges at their graph's node 0);
    emask [B, E] in h's dtype.  ``ctx``: the edges are this rank's block
    of the graph's; the node-side segment sums are summed over the
    mesh."""
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
    denom = _psum(_segment_sum(sig.reshape(bsz * n_e, hd), dst, bsz * n),
                  ctx)
    eta = sig / (denom.index_select(0, dst).reshape(bsz, n_e, hd) + 1e-6)
    msg = eta * dense_apply(p["B"], hi) * m
    agg = _psum(_segment_sum(msg.reshape(bsz * n_e, hd), dst, bsz * n),
                ctx).reshape(bsz, n, hd)
    h_new = h + torch.relu(batch_norm_apply(
        p["bn_h"], dense_apply(p["A"], h) + agg, axes=(1,)))
    e_new = e + torch.relu(_bn_edges(p["bn_e"], e_hat, emask, ctx=ctx))
    return h_new, e_new


def _edge_parallel(ctx, batch: dict) -> bool:
    return (ctx is not None and batch["edges"].shape[0] == 1
            and batch["edges"].shape[1] >= EDGE_PARALLEL_MIN)


def _rows(batch: dict, ctx) -> dict:
    """This rank's graphs of ``batch`` (all of them outside a mesh)."""
    if ctx is None:
        return batch
    rows = dist.batch_rows(ctx, batch["edges"].shape[0])
    return {k: v[rows] for k, v in batch.items()}


def forward(params, cfg: GatedGCNConfig, batch: dict) -> torch.Tensor:
    """-> logits: [B, N, n_classes] (node task) or [B, n_classes] (graph).
    Under a mesh: the global batch in, the global logits out."""
    ctx = dist.current()
    if _edge_parallel(ctx, batch):
        return _forward_rows(params, cfg, batch, ctx)
    return dist.gather_rows(_forward_rows(params, cfg, _rows(batch, ctx)),
                            batch["edges"].shape[0])


def _forward_rows(params, cfg: GatedGCNConfig, batch: dict,
                  ctx=None) -> torch.Tensor:
    """The logits of the graphs of ``batch``; with ``ctx``, its one graph
    edge-parallel on that mesh."""
    nodes = batch["nodes"]
    edges = batch["edges"].long()              # [B, E, 2], -1 padded
    bsz, n, _ = nodes.shape
    if ctx is not None:
        # this rank's block of the edges, over the mesh's linear order
        axes = tuple(ctx.mesh.axis_names)
        k = ctx.size(axes)
        if edges.shape[1] % k:
            raise ValueError(f"gatedgcn edge-parallel: {edges.shape[1]} "
                             f"edges do not divide the mesh's {k} ranks")
        m = edges.shape[1] // k
        edges = edges[:, ctx.index(axes) * m:(ctx.index(axes) + 1) * m]
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
        h, e = _layer(p, h, e, src, dst, emask, ctx)
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
    ``label_mask`` selects (node task; all nodes without one).  Under a
    mesh the value is the global mean and the gradient that of the
    rank's share (``dist.api`` contract point 4): shares that add up to
    n times the global mean over the n ranks."""
    ctx = dist.current()
    n_graphs = batch["edges"].shape[0]
    if _edge_parallel(ctx, batch):
        # every rank holds the whole logits: its share is the whole loss
        logits, split = _forward_rows(params, cfg, batch, ctx), False
    else:
        split = ctx is not None and dist.batch_split(ctx, n_graphs)
        batch = _rows(batch, ctx)
        logits = _forward_rows(params, cfg, batch)
    labels = batch["labels"].long()
    lse = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    per = lse - gold
    mask = batch.get("label_mask")
    if cfg.task == "graph_class" or mask is None:
        loss = per.mean()
        if split:
            total = coll.all_reduce_(loss.detach().clone(), ctx,
                                     ctx.mesh.axis_names)
            loss = loss + (total / ctx.n_devices - loss).detach()
    else:
        w = mask.to(per.dtype)
        if split:
            # the masked mean over every rank's nodes: each rank's sum over
            # the global count (no gradient through the count), n times
            axes = ctx.mesh.axis_names
            part = (per * w).sum()
            cnt = torch.clamp_min(coll.all_reduce_(w.sum(), ctx, axes), 1.0)
            share = part * (ctx.n_devices / cnt)
            total = coll.all_reduce_(part.detach().clone(), ctx, axes) / cnt
            loss = share + (total - share).detach()
        else:
            loss = (per * w).sum() / torch.clamp_min(w.sum(), 1.0)
    return loss, {"loss": loss}
