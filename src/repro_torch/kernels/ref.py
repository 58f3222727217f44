"""Plain PyTorch versions of the port's kernels: the six forward kernels
and the backwards of every op (``robe_lookup``, ``dot_interaction``,
``qrobe_lookup``, ``qr_lookup``, ``tt_lookup`` and ``serve_fused``); and
the CIN layer's oracle (``cin_layer_ref``), which the chunked CIN of
``nn.interactions`` is held against.

Each function is the semantics its Hopper kernel is held against: the CPU
path of ``repro_torch.kernels.ops`` runs them, the tests hold them against
the JAX package, and ``chip_smoke.py`` holds each CUDA kernel against them
on the card.  They repeat the kernels' arithmetic (f32 accumulation, one
rounding into the output dtype) and are no yardstick of speed.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.robe import (RobeSpec, robe_lookup as _core_lookup,
                                   robe_signs, robe_slots)


def robe_lookup_ref(memory: torch.Tensor, rows: torch.Tensor,
                    table_ids, dim: int, spec: RobeSpec) -> torch.Tensor:
    """[B, F] rows (+ per-field table ids) -> [B, F, dim] embeddings."""
    tids = torch.as_tensor(table_ids, dtype=torch.int64, device=rows.device)
    return _core_lookup(memory, spec, tids[None, :], rows, dim)


def robe_lookup_bwd_ref(g: torch.Tensor, rows: torch.Tensor, table_ids,
                        dim: int, spec: RobeSpec) -> torch.Tensor:
    """The lookup's cotangent g [B, F, dim] -> gM [|M|] in g's dtype (M's):
    the paper's Fig.-2 scatter-add of every element's ``g · sign`` into the
    slot its forward read, accumulated in f32 and rounded once."""
    tids = torch.as_tensor(table_ids, dtype=torch.int64,
                           device=rows.device)[None, :]
    slots = robe_slots(spec, tids, rows, dim)            # [B, F, dim] int64
    g32 = g.to(torch.float32)
    if spec.use_sign:
        g32 = g32 * robe_signs(spec, tids, rows, dim)
    gm = torch.zeros(spec.size, dtype=torch.float32, device=g.device)
    return gm.index_add_(0, slots.reshape(-1), g32.reshape(-1)).to(g.dtype)


def qrobe_dequant_ref(codes: torch.Tensor, scale: torch.Tensor,
                      group_log2: int) -> torch.Tensor:
    """The f32 array an int8 ROBE substrate represents: slot s is
    ``codes[s] · scale[s >> group_log2]``, all in f32."""
    gidx = torch.arange(codes.shape[0], device=codes.device) >> group_log2
    return codes.to(torch.float32) * scale.to(torch.float32)[gidx]


def qrobe_lookup_ref(codes: torch.Tensor, scale: torch.Tensor,
                     rows: torch.Tensor, table_ids, dim: int,
                     spec: RobeSpec, group_log2: int,
                     delta: torch.Tensor | None = None) -> torch.Tensor:
    """[B, F] rows -> [B, F, dim]: int8 codes gathered through the ROBE
    hash, each dequantized in f32 against the scale of its (wrapped) slot's
    group, times the ±1 sign, rounded ONCE into ``scale.dtype``.  Given the
    f32 ``delta`` array, the qrobe backend's straight-through term: a ROBE
    lookup of ``delta`` (``delta[slot] · sign``), rounded into the output's
    dtype and added, as the JAX backend sums the two."""
    tids = torch.as_tensor(table_ids, dtype=torch.int64,
                           device=rows.device)[None, :]
    slots = robe_slots(spec, tids, rows, dim)            # [B, F, dim] int64
    out = codes[slots].to(torch.float32) * \
        scale.to(torch.float32)[slots >> group_log2]
    if spec.use_sign:
        out = out * robe_signs(spec, tids, rows, dim)
    out = out.to(scale.dtype)
    if delta is not None:
        out = out + robe_lookup_ref(delta, rows, table_ids, dim,
                                    spec).to(out.dtype)
    return out


def qrobe_lookup_bwd_ref(g: torch.Tensor, codes: torch.Tensor,
                         rows: torch.Tensor, table_ids, dim: int,
                         spec: RobeSpec, group_log2: int) -> tuple:
    """The int8 lookup's cotangent g [B, F, dim] (in the scale's dtype) ->
    (gscale [ceil(|M| / 2^group_log2)] in g's dtype, gdelta [|M|] f32).

    ``gscale[k]`` sums ``g · sign · code`` over the elements whose slot lies
    in group k (the JAX package's ``_qrobe_bwd``); ``gdelta`` is the
    scatter-add of ``g · sign`` into the slots (what autodiff gives the
    backend's ``delta`` term).  Both accumulate in f32."""
    tids = torch.as_tensor(table_ids, dtype=torch.int64,
                           device=rows.device)[None, :]
    slots = robe_slots(spec, tids, rows, dim).reshape(-1)
    g32 = g.to(torch.float32)
    if spec.use_sign:
        g32 = g32 * robe_signs(spec, tids, rows, dim)
    g32 = g32.reshape(-1)
    n_groups = -(-spec.size // (1 << group_log2))
    gscale = torch.zeros(n_groups, dtype=torch.float32, device=g.device)
    gscale.index_add_(0, slots >> group_log2,
                      g32 * codes[slots].to(torch.float32))
    gdelta = torch.zeros(spec.size, dtype=torch.float32, device=g.device)
    return gscale.to(g.dtype), gdelta.index_add_(0, slots, g32)


def dot_interaction_ref(feats: torch.Tensor, self_interaction: bool = False
                        ) -> torch.Tensor:
    """DLRM pairwise-dot feature interaction.

    feats: [B, F, D] -> [B, F*(F-1)/2] (strictly-lower triangle of the gram
    matrix, +F diagonal terms if self_interaction) in ``np.tril_indices``
    order -- (1,0), (2,0), (2,1), (3,0), ... -- accumulated in f32 and
    delivered in ``feats``' dtype.
    """
    f32 = feats.to(torch.float32)
    gram = torch.bmm(f32, f32.transpose(1, 2))
    rows, cols = np.tril_indices(feats.shape[1],
                                 k=0 if self_interaction else -1)
    return gram[:, rows, cols].to(feats.dtype)


def interaction_sym(g: torch.Tensor, n: int, self_interaction: bool
                    ) -> torch.Tensor:
    """The triangle cotangent g [B, P] -> the symmetric [B, n, n] f32 matrix
    with g_ij at (i, j) and (j, i); with the diagonal, 2·g_ii at (i, i)."""
    rows, cols = np.tril_indices(n, k=0 if self_interaction else -1)
    g32 = g.to(torch.float32)
    sym = torch.zeros((g.shape[0], n, n), dtype=torch.float32,
                      device=g.device)
    sym[:, rows, cols] += g32
    sym[:, cols, rows] += g32
    return sym


def dot_interaction_bwd_ref(g: torch.Tensor, feats: torch.Tensor,
                            self_interaction: bool = False) -> torch.Tensor:
    """The interaction's cotangent g [B, P] and its input feats [B, F, D]
    -> dfeats [B, F, D] = sym(g) · feats, accumulated in f32 and rounded
    once into feats' dtype."""
    sym = interaction_sym(g, feats.shape[1], self_interaction)
    return torch.bmm(sym, feats.to(torch.float32)).to(feats.dtype)


def serve_fused_ref(memory: torch.Tensor, idx: torch.Tensor,
                    bot: torch.Tensor, table_ids, dim: int,
                    spec: RobeSpec) -> torch.Tensor:
    """ROBE lookup -> masked bag pooling -> DLRM dot interaction against the
    bottom-MLP output, in one function.

    idx: [B, F] or [B, F, bag] int32 row ids (-1 = padded bag slot);
    bot: [B, dim] -> [B, (F+1)·F/2] in ``bot``'s dtype.  Bags are summed in
    f32 and rounded ONCE to ``bot``'s dtype before the f32 gram.
    """
    _, _, _, pooled = _bags(memory, idx, table_ids, dim, spec)
    feats = torch.cat([bot[:, None, :], pooled.to(bot.dtype)], dim=1)
    return dot_interaction_ref(feats, False)


def _bags(memory, idx, table_ids, dim, spec) -> tuple:
    """idx [B, F] or [B, F, bag] (-1 = pad) -> (its pad mask, the rows with
    pads read as row 0, the table ids [1, F, 1], the f32 bag sums
    [B, F, dim] of the lookups)."""
    if idx.dim() == 2:
        idx = idx[..., None]
    mask = idx >= 0
    safe = torch.where(mask, idx, torch.zeros_like(idx))
    tids = torch.as_tensor(table_ids, dtype=torch.int64,
                           device=idx.device)[None, :, None]
    emb = _core_lookup(memory, spec, tids, safe, dim)     # [B, F, bag, dim]
    return mask, safe, tids, (emb.to(torch.float32) * mask[..., None]).sum(
        dim=2)


def serve_fused_bwd_ref(g: torch.Tensor, memory: torch.Tensor,
                        idx: torch.Tensor, bot: torch.Tensor, table_ids,
                        dim: int, spec: RobeSpec) -> tuple:
    """The serve op's cotangent g [B, (F+1)·F/2] -> (gM [|M|] in M's dtype,
    gbot [B, dim] in bot's dtype), as the JAX package's ``_serve_bwd``:
    the pooled features recomputed, the gram transpose applied to [bot;
    pooled] in f32, and the pooled rows' cotangent broadcast over each bag,
    zeroed at the -1 pads and scatter-added into M (sign-corrected, f32)."""
    mask, safe, tids, pooled = _bags(memory, idx, table_ids, dim, spec)
    feats = torch.cat([bot[:, None, :].to(torch.float32),
                       pooled.to(bot.dtype).to(torch.float32)], dim=1)
    dfeats = dot_interaction_bwd_ref(g.to(torch.float32), feats, False)
    dpool = dfeats[:, 1:, None, :] * mask[..., None]      # [B, F, bag, dim]
    if spec.use_sign:
        dpool = dpool * robe_signs(spec, tids, safe, dim)
    slots = robe_slots(spec, tids, safe, dim)
    gm = torch.zeros(spec.size, dtype=torch.float32, device=g.device)
    gm.index_add_(0, slots.reshape(-1), dpool.reshape(-1))
    return gm.to(memory.dtype), dfeats[:, 0].to(bot.dtype)


def cin_layer_ref(x0: torch.Tensor, xk: torch.Tensor, w: torch.Tensor
                  ) -> torch.Tensor:
    """xDeepFM Compressed Interaction Network layer (the oracle of
    ``nn.interactions.cin_layer``).

    x0: [B, F0, D] base field embeddings; xk: [B, Fk, D] previous layer;
    w: [H, F0, Fk] compression weights -> [B, H, D].
    z[b,i,j,d] = x0[b,i,d] * xk[b,j,d]; out[b,h,d] = Σ_ij w[h,i,j] z[b,i,j,d].
    """
    return torch.einsum("bid,bjd,hij->bhd", x0, xk, w)


def qr_indices(idx: torch.Tensor, q_off, r_off, m: int) -> tuple:
    """[B, F] ids -> (q_idx, r_idx) rows of the concatenated Q / R tables,
    with floor division and remainder as ``jnp`` takes them."""
    q = torch.as_tensor(q_off, dtype=idx.dtype, device=idx.device)[None, :]
    r = torch.as_tensor(r_off, dtype=idx.dtype, device=idx.device)[None, :]
    return idx // m + q, idx % m + r


def tt_indices(idx: torch.Tensor, offsets, factors) -> tuple:
    """[B, F] ids -> (i1, i2, i3) core rows of the global row id + off[f],
    mixed-radix over ``factors`` = (n1, n2, n3) with i3 fastest."""
    _, n2, n3 = factors
    g = idx + torch.as_tensor(offsets, dtype=idx.dtype,
                              device=idx.device)[None, :]
    rest = g // n3
    return rest // n2, rest % n2, g % n3


def qr_lookup_ref(q_table: torch.Tensor, r_table: torch.Tensor,
                  idx: torch.Tensor, q_off, r_off, m: int) -> torch.Tensor:
    """``Q[id // m + q_off[f]] * R[id % m + r_off[f]]`` -> [B, F, dim]: one
    f32 product, rounded once to ``q_table.dtype``."""
    q_idx, r_idx = qr_indices(idx, q_off, r_off, m)
    prod = q_table[q_idx.long()].to(torch.float32) * \
        r_table[r_idx.long()].to(torch.float32)
    return prod.to(q_table.dtype)


def tt_lookup_ref(core0: torch.Tensor, core1: torch.Tensor,
                  core2: torch.Tensor, idx: torch.Tensor, offsets,
                  factors, dim: int) -> torch.Tensor:
    """Per-row tensor-train chain G1[i1]·G2[i2]·G3[i3] -> [B, F, dim].

    ``t = c1·c2`` is accumulated in f32 and not rounded; ``e = t·c3`` in
    f32, rounded once to the core dtype.
    """
    i1, i2, i3 = tt_indices(idx, offsets, factors)
    c1 = core0[i1.long()].to(torch.float32)          # [B, F, d1, r]
    c2 = core1[i2.long()].to(torch.float32)          # [B, F, r, d2, r]
    c3 = core2[i3.long()].to(torch.float32)          # [B, F, r, d3]
    t = torch.einsum("...ap,...pbq->...abq", c1, c2)
    e = torch.einsum("...abq,...qc->...abc", t, c3)
    return e.reshape(e.shape[:-3] + (dim,)).to(core0.dtype)


def qr_lookup_bwd_ref(g: torch.Tensor, q_table: torch.Tensor,
                      r_table: torch.Tensor, idx: torch.Tensor, q_off, r_off,
                      m: int) -> tuple:
    """The QR lookup's cotangent g [B, F, dim] -> (gQ, gR) in the tables'
    dtype, by the product rule: each factor's row takes ``g`` times the
    other factor's row, scatter-added in f32 (the JAX package's
    ``_qr_bwd``)."""
    q_idx, r_idx = qr_indices(idx, q_off, r_off, m)
    q_idx, r_idx = q_idx.reshape(-1).long(), r_idx.reshape(-1).long()
    dim = q_table.shape[1]
    g32 = g.to(torch.float32).reshape(-1, dim)
    qv = q_table[q_idx].to(torch.float32)
    rv = r_table[r_idx].to(torch.float32)
    gq = torch.zeros(q_table.shape, dtype=torch.float32, device=g.device)
    gr = torch.zeros(r_table.shape, dtype=torch.float32, device=g.device)
    gq.index_add_(0, q_idx, g32 * rv)
    gr.index_add_(0, r_idx, g32 * qv)
    return gq.to(q_table.dtype), gr.to(r_table.dtype)


def tt_lookup_bwd_ref(g: torch.Tensor, core0: torch.Tensor,
                      core1: torch.Tensor, core2: torch.Tensor,
                      idx: torch.Tensor, offsets, factors) -> tuple:
    """The tensor-train lookup's cotangent g [B, F, d1·d2·d3] -> the three
    cores' gradients in their dtype: the chain rule through
    ``e = (c1·c2)·c3`` per item, each core row's gradient scatter-added in
    f32 (the JAX package's ``_tt_bwd``)::

        t = c1·c2,  dc3 = tᵀ·g,  dt = g·c3ᵀ,  dc1 = dt·c2ᵀ,  dc2 = c1ᵀ·dt
    """
    i1, i2, i3 = (i.reshape(-1).long()
                  for i in tt_indices(idx, offsets, factors))
    d1, d2, d3 = core0.shape[1], core1.shape[2], core2.shape[2]
    c1 = core0[i1].to(torch.float32)                 # [N, d1, r]
    c2 = core1[i2].to(torch.float32)                 # [N, r, d2, r]
    c3 = core2[i3].to(torch.float32)                 # [N, r, d3]
    g32 = g.to(torch.float32).reshape(-1, d1, d2, d3)
    t = torch.einsum("nap,npbq->nabq", c1, c2)
    dc3 = torch.einsum("nabq,nabc->nqc", t, g32)
    dt = torch.einsum("nabc,nqc->nabq", g32, c3)
    dc1 = torch.einsum("nabq,npbq->nap", dt, c2)
    dc2 = torch.einsum("nap,nabq->npbq", c1, dt)
    out = []
    for core, rows, d in ((core0, i1, dc1), (core1, i2, dc2),
                          (core2, i3, dc3)):
        acc = torch.zeros(core.shape, dtype=torch.float32, device=g.device)
        out.append(acc.index_add_(0, rows, d).to(core.dtype))
    return tuple(out)


def qr_materialize_ref(q_table: torch.Tensor, r_table: torch.Tensor,
                       vocab_sizes, m: int) -> torch.Tensor:
    """The whole [total_rows, dim] table a QR (quotient x remainder)
    substrate represents: the oracle of the ``hashed`` backend's per-row
    path (autograd-able)."""
    out = []
    q_off = 0
    for f, v in enumerate(vocab_sizes):
        x = torch.arange(int(v), device=q_table.device)
        out.append(q_table[q_off + x // m] * r_table[f * m + x % m])
        q_off += -(-int(v) // m)
    return torch.cat(out, dim=0)


def tt_materialize_ref(core0: torch.Tensor, core1: torch.Tensor,
                       core2: torch.Tensor) -> torch.Tensor:
    """The whole [n1·n2·n3, d1·d2·d3] table a tensor-train substrate
    represents, by one whole-tensor einsum (autograd-able): the oracle of
    the ``tt`` backend's per-row chain.  Row g is (i1, i2, i3) with i3
    fastest, the backend's mixed-radix split."""
    n1, d1, _ = core0.shape
    n2, _, d2, _ = core1.shape
    n3, _, d3 = core2.shape
    t = torch.einsum("iap,jpbq,kqc->ijkabc", core0, core1, core2)
    return t.reshape(n1 * n2 * n3, d1 * d2 * d3)
