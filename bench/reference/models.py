"""The plain reference of the benchmark's configurations.

Plain PyTorch in float32 with TF32 off, following the published models:
the DLRM of the MLPerf reference (facebookresearch/dlrm: a ReLU bottom
MLP over the dense features, the strictly-lower triangle of the gram
matrix of [bottom output; field embeddings], a top MLP over [bottom
output; triangle], ReLU between its layers) and xDeepFM (Lian et al.
2018: x^k[h, d] = sum_ij W^k[h, i, j] x0[i, d] x^{k-1}[j, d], each layer
sum-pooled over d, beside a ReLU DNN and a linear term, all summed into
one logit), both over a ROBE array (``robe_hash.Robe``).  Binary cross
entropy on the logits; SGD is ``p - lr * g``.  The weights are the
benchmark's (``lib.params``), in the program's tree.  Everything runs in
blocks of rows so that it fits beside nothing else on the card.  Nothing
here imports the program.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from reference.robe_hash import Robe


@contextlib.contextmanager
def full_f32():
    """float32 matmuls in full precision, TF32 off, whatever the caller
    set."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def robe_of(cfg: dict) -> Robe:
    return Robe(size=cfg["robe_size"], block=cfg["robe_block"],
                seed=cfg["robe_seed"], use_sign=cfg["robe_use_sign"])


def _mlp(layers, x, final_relu=False):
    for i, p in enumerate(layers):
        x = x @ p["w"] + p["b"]
        if i < len(layers) - 1 or final_relu:
            x = torch.relu(x)
    return x


def dlrm_logits(params: dict, cfg: dict, dense: torch.Tensor,
                sparse: torch.Tensor) -> torch.Tensor:
    robe = robe_of(cfg)
    bot = _mlp(params["bot"], dense, final_relu=True)         # [B, d]
    emb = robe.lookup(params["embedding"]["memory"], sparse,
                      cfg["embed_dim"])                          # [B, F, d]
    feats = torch.cat([bot[:, None, :], emb], dim=1)
    gram = feats @ feats.transpose(1, 2)
    r, c = np.tril_indices(feats.shape[1], k=-1)
    tri = gram[:, torch.from_numpy(r).to(gram.device),
               torch.from_numpy(c).to(gram.device)]
    return _mlp(params["top"], torch.cat([bot, tri], dim=1))[:, 0]


def xdeepfm_logits(params: dict, cfg: dict, sparse: torch.Tensor
                   ) -> torch.Tensor:
    robe = robe_of(cfg)
    x0 = robe.lookup(params["embedding"]["memory"], sparse,
                     cfg["embed_dim"])                           # [B, F, d]
    b = x0.shape[0]
    xk, pooled = x0, []
    for layer in params["cin"]:
        z = x0[:, :, None, :] * xk[:, None, :, :]                # [B, F, Fk, d]
        w = layer["w"]
        xk = torch.matmul(w.reshape(w.shape[0], -1),
                          z.reshape(b, -1, z.shape[-1]))         # [B, H, d]
        pooled.append(xk.sum(dim=-1))
    cin = torch.cat(pooled, dim=1)
    flat = x0.reshape(b, -1)
    out = params["cin_out"]
    lin = params["linear"]
    return ((cin @ out["w"] + out["b"])[:, 0] + _mlp(params["dnn"], flat)[:, 0]
            + (flat @ lin["w"] + lin["b"])[:, 0])


def logits(params: dict, cfg: dict, batch: dict) -> torch.Tensor:
    if cfg["arch"] == "dlrm":
        return dlrm_logits(params, cfg, batch["dense"], batch["sparse"])
    return xdeepfm_logits(params, cfg, batch["sparse"])


#: rows a block of the reference computes at once
BLOCK = {"dlrm": 16384, "xdeepfm": 2048}


def scores(params: dict, cfg: dict, batch: dict, device) -> np.ndarray:
    """The logits of a host batch ({"dense", "sparse"} numpy), in blocks."""
    n = batch["sparse"].shape[0]
    blk = BLOCK[cfg["arch"]]
    out = []
    with torch.no_grad(), full_f32():
        for s in range(0, n, blk):
            part = {k: torch.as_tensor(v[s:s + blk]).to(device)
                    for k, v in batch.items() if k in ("dense", "sparse")}
            out.append(logits(params, cfg, part).cpu().numpy())
    return np.concatenate(out)


def bce(logit: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Summed binary cross entropy of logits against 0/1 labels."""
    y = label.to(torch.float32)
    return torch.sum(torch.clamp_min(logit, 0) - logit * y
                     + torch.log1p(torch.exp(-torch.abs(logit))))


def loss_and_grad(params: dict, cfg: dict, batch: dict, device):
    """(mean loss, gradient tree) of a host batch with labels, the
    gradient summed over blocks of rows."""
    leaves, unflat = flatten(params)
    xs = [p.detach().clone().requires_grad_(True) for p in leaves]
    tree = unflat(xs)
    n = batch["sparse"].shape[0]
    blk = BLOCK[cfg["arch"]]
    total = torch.zeros((), dtype=torch.float64, device=device)
    grads = [torch.zeros_like(p) for p in leaves]
    with full_f32():
        for s in range(0, n, blk):
            part = {k: torch.as_tensor(v[s:s + blk]).to(device)
                    for k, v in batch.items()}
            loss = bce(logits(tree, cfg, part), part["label"]) / n
            gs = torch.autograd.grad(loss, xs)
            for acc, g in zip(grads, gs):
                acc += g
            total += loss.detach().to(torch.float64)
    return float(total), unflat(grads)


def sgd(params: dict, grads: dict, lr: float) -> dict:
    p, unflat = flatten(params)
    g, _ = flatten(grads)
    return unflat([a - lr * b for a, b in zip(p, g)])


def flatten(tree):
    """(leaves in sorted-key order, a function that rebuilds the tree)."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [flatten(t) for t in tree]
    else:
        return [tree], lambda xs: xs[0]
    sizes = [len(p[0]) for p in parts]
    leaves = [x for p in parts for x in p[0]]

    def unflat(xs):
        out, at = [], 0
        for (_, f), n in zip(parts, sizes):
            out.append(f(xs[at:at + n]))
            at += n
        return dict(zip(keys, out)) if keys is not None else out
    return leaves, unflat


def leaf_names(tree, prefix="") -> list:
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in
                leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree) for n in
                leaf_names(t, f"{prefix}{i}.")]
    return [prefix[:-1]]
