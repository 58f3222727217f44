"""Attention for the LM family (PyTorch port of ``repro.nn.attention``): GQA
(with qk-norm and qkv-bias options) and MLA.

Causal attention is *chunked* over queries: ``q_chunk`` queries at a time,
so the [T, T] score matrix never exists whole (the 32k prefill).  Decode
takes one-token queries against a KV cache; MLA decodes in the
**absorbed** latent form, against the compressed ``c_kv`` cache.  Plain
PyTorch: einsum -> f32 softmax -> einsum, as the JAX package computes it.

A decode step writes the new keys and values into the cache tensors in
place (the JAX package returns updated copies) and returns the same cache
dict.

With ``tp`` (a ``dist.tp.Tp``, under a mesh) the block is head-parallel:
``p`` holds the compute views of the rank's heads (q, k, v and MLA's
up-projections column-cut, ``wo`` row-cut; ``models.transformer`` makes
them) and the output is the rank's partial sum of ``wo``, which the
caller reduces.  When the kv heads do not cut with the q heads, ``wk``
and ``wv`` come whole and each rank takes the kv heads its q heads read.
The decode cache is cut along the sequence instead (``seq_kv_model``):
each rank holds ``S / M`` positions of every head, attends them for all
heads (the queries gathered over the model axes), and the partial
softmaxes are merged by log-sum-exp over the model axes; the rank that
holds ``pos`` writes the new keys and values (an int8 cache's scales on
the same cut).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.dist import collectives as coll
from repro_torch.nn.core import (dense_apply, dense_init, rms_norm_apply,
                                 rms_norm_init)

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    kind: str = "gqa"            # "gqa" | "mla"
    qk_norm: bool = False        # qwen3
    qkv_bias: bool = False       # qwen1.5
    rope_theta: float = 1e4
    q_chunk: int = 512           # 0 = unchunked
    # MLA dims (minicpm3 / deepseek-style; q_lora_rank 0: no q
    # down-projection, one w_q as DeepSeek-V2-Lite and Moonlight have)
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64


# ---------------------------------------------------------------------------
# RoPE (the two halves of a head rotate together: not interleaved)
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [..., T] -> cos, sin [..., T, dim/2] (f32)."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                       device=positions.device), exps)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [..., T, H, D]; cos/sin [..., T, D/2] broadcast over heads."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# chunked causal GQA math (shared by gqa and the expanded mla form)
# ---------------------------------------------------------------------------

def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            q_offset: int, kv_len: Optional[torch.Tensor],
            scale: float) -> torch.Tensor:
    """q [B,Tq,Kv,G,D] k [B,S,Kv,D] v [B,S,Kv,Dv] -> [B,Tq,Kv,G,Dv]."""
    s = torch.einsum("btkgd,bskd->bkgts", q, k).to(torch.float32) * scale
    tq, sk = q.shape[1], k.shape[1]
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=s.device)
    if causal:
        qpos = q_offset + torch.arange(tq, device=s.device)
        mask = qpos[:, None] >= torch.arange(sk, device=s.device)[None, :]
        s = torch.where(mask, s, neg)
    if kv_len is not None:                      # decode: only filled slots
        valid = torch.arange(sk, device=s.device)[None, :] < kv_len[:, None]
        s = torch.where(valid[:, None, None, None], s, neg)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bkgts,bskd->btkgd", p, v)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      n_kv: int, q_chunk: int, causal: bool = True,
                      q_offset: int = 0,
                      kv_len: Optional[torch.Tensor] = None,
                      scale: Optional[float] = None) -> torch.Tensor:
    """q [B,T,H,D] k/v [B,S,Kv,D*] -> [B,T,H,Dv].

    Chunks over queries only when ``T > q_chunk`` and ``q_chunk`` divides
    ``T``, as the JAX package's scan does: live scores are then
    [B, Kv, G, q_chunk, S]."""
    b, t, h, d = q.shape
    g = h // n_kv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, t, n_kv, g, d)
    if q_chunk and t > q_chunk and t % q_chunk == 0:
        outs = [_attend(qg[:, i:i + q_chunk], k, v, causal, q_offset + i,
                        kv_len, scale)
                for i in range(0, t, q_chunk)]
        out = torch.cat(outs, dim=1)
    else:
        out = _attend(qg, k, v, causal, q_offset, kv_len, scale)
    return out.reshape(b, t, h, -1)


def _pos0(positions: torch.Tensor) -> int:
    return int(positions[0] if positions.dim() else positions)


def _write(buf: torch.Tensor, val: torch.Tensor, pos0: int,
           tp=None) -> None:
    """The cache's ``dynamic_update_slice`` at ``pos0`` along dim 1, in
    place.  With ``tp`` ``buf`` is the rank's block of a sequence-cut
    cache, positions ``index·S .. index·S + S - 1`` of ``M·S``: the
    positions of ``val`` outside it are other ranks'."""
    t, s = val.shape[1], buf.shape[1]
    n, off = (1, 0) if tp is None else (tp.size, tp.index * s)
    if pos0 < 0 or pos0 + t > n * s:
        raise ValueError(f"cache write at {pos0}..{pos0 + t} outside its "
                         f"{n * s} slots")
    lo, hi = max(pos0, off), min(pos0 + t, off + s)
    if lo < hi:
        buf[:, lo - off:hi - off] = val[:, lo - pos0:hi - pos0].to(buf.dtype)


def _slot_mask(s: torch.Tensor, kv_len: torch.Tensor, tp) -> torch.Tensor:
    """Scores [b, ..., S] of the rank's cache block with the slots at or
    past ``kv_len`` (global positions) set to NEG_INF."""
    sk = s.shape[-1]
    slot = tp.index * sk + torch.arange(sk, device=s.device)
    valid = slot[None, :] < kv_len[:, None]
    valid = valid.reshape(valid.shape[:1] + (1,) * (s.dim() - 2)
                          + valid.shape[1:])
    return torch.where(valid, s, torch.tensor(NEG_INF, dtype=s.dtype,
                                              device=s.device))


def _merged_softmax(s: torch.Tensor, tp) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The exponentials of the scores [..., S] against the largest score
    of every rank's block, and their sum over every rank's block [..., 1]
    (f32): a softmax over the whole cut sequence is e / l."""
    m = coll.all_reduce_(s.detach().amax(-1, keepdim=True).contiguous(),
                         tp.ctx, tp.axes, "max")
    e = torch.exp(s - m)
    return e, coll.all_reduce(e.sum(-1, keepdim=True), tp.ctx, tp.axes)


def _heads_tp(cfg: AttnConfig, tp) -> Tuple[bool, bool]:
    """(q heads cut over the model axes, kv heads cut with them)."""
    if tp is None:
        return False, False
    heads = tp.splits(cfg.n_heads)
    return heads, heads and tp.splits(cfg.n_kv_heads)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------

def gqa_init(generator: torch.Generator, cfg: AttnConfig, device) -> dict:
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    p = {"wq": dense_init(generator, cfg.d_model, nh * hd, device,
                          bias=cfg.qkv_bias, scale=0.02),
         "wk": dense_init(generator, cfg.d_model, nkv * hd, device,
                          bias=cfg.qkv_bias, scale=0.02),
         "wv": dense_init(generator, cfg.d_model, nkv * hd, device,
                          bias=cfg.qkv_bias, scale=0.02),
         "wo": dense_init(generator, nh * hd, cfg.d_model, device,
                          bias=False, scale=0.02)}
    if cfg.qk_norm:
        p["q_norm"] = rms_norm_init(hd, device)
        p["k_norm"] = rms_norm_init(hd, device)
    return p


def _q8(val: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per (position, kv-head): scale max|v| / 127 + 1e-12,
    codes rounded half to even and clipped to ±127."""
    s = val.abs().amax(dim=-1) / 127.0 + 1e-12
    qv = torch.clamp(torch.round(val / s[..., None]), -127, 127)
    return qv.to(torch.int8), s.to(torch.float32)


def gqa_apply(p: dict, cfg: AttnConfig, x: torch.Tensor,
              positions: torch.Tensor, cache: Optional[dict] = None,
              kv_len: Optional[torch.Tensor] = None,
              return_kv: bool = False,
              tp=None) -> Tuple[torch.Tensor, Optional[dict]]:
    """x [B,T,D].  ``cache`` = {"k", "v"} [B,S,Kv,hd] (+ "k_scale",
    "v_scale" [B,S,Kv] for an int8 cache): decode; the new keys and values
    are written at ``positions[0]``.  ``return_kv`` (prefill): also return
    the sequence's {"k", "v"} (every kv head).  ``tp``: head-parallel on a
    mesh (the module's docstring); the result is then the rank's partial
    sum."""
    b, t, _ = x.shape
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    heads, kv_cut = _heads_tp(cfg, tp)
    nh_l = nh // tp.size if heads else nh
    nkv_l = nkv // tp.size if kv_cut else nkv
    q = dense_apply(p["wq"], x).reshape(b, t, nh_l, hd)
    k = dense_apply(p["wk"], x).reshape(b, t, nkv_l, hd)
    v = dense_apply(p["wv"], x).reshape(b, t, nkv_l, hd)
    if cfg.qk_norm:
        q = rms_norm_apply(p["q_norm"], q)
        k = rms_norm_apply(p["k_norm"], k)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache is not None:
        pos0 = _pos0(positions)
        if tp is not None:                       # every kv head, all q
            if kv_cut:
                k, v = tp.gather(k, 2), tp.gather(v, 2)
            if heads:
                q = tp.gather(q, 2)
        if "k_scale" in cache:
            qk, sk = _q8(k.to(torch.float32))
            qv, sv = _q8(v.to(torch.float32))
            _write(cache["k"], qk, pos0, tp)
            _write(cache["v"], qv, pos0, tp)
            _write(cache["k_scale"], sk, pos0, tp)
            _write(cache["v_scale"], sv, pos0, tp)
            kf = (cache["k"].to(x.dtype)
                  * cache["k_scale"][..., None].to(x.dtype))
            vf = (cache["v"].to(x.dtype)
                  * cache["v_scale"][..., None].to(x.dtype))
        else:
            _write(cache["k"], k, pos0, tp)
            _write(cache["v"], v, pos0, tp)
            kf = cache["k"].to(x.dtype)
            vf = cache["v"].to(x.dtype)
        if tp is None:
            out = chunked_attention(q, kf, vf, nkv, 0, causal=False,
                                    kv_len=kv_len)
        else:
            out = _gqa_decode_cut(q, kf, vf, nkv, kv_len, tp).to(x.dtype)
            if heads:
                out = tp.block(out, 2)
    else:
        kk, vv, n_kv = k, v, nkv_l
        if heads and not kv_cut:
            # the kv heads this rank's q heads read: one when a kv head's
            # group holds them all, else one per q head
            g = nh // nkv
            kvh = [(tp.index * nh_l + j) // g for j in range(nh_l)]
            if g % nh_l == 0:
                kk, vv, n_kv = k[:, :, kvh[0]:kvh[0] + 1], \
                    v[:, :, kvh[0]:kvh[0] + 1], 1
            else:
                kk, vv, n_kv = k[:, :, kvh], v[:, :, kvh], nh_l
        out = chunked_attention(q, kk, vv, n_kv, cfg.q_chunk, causal=True)
        if return_kv:
            cache = {"k": tp.gather(k, 2) if kv_cut else k,
                     "v": tp.gather(v, 2) if kv_cut else v}
    out = out.reshape(b, t, nh_l * hd)
    return dense_apply(p["wo"], out), cache


def _gqa_decode_cut(q, k, v, n_kv: int, kv_len, tp) -> torch.Tensor:
    """q [B,T,H,D] against the rank's block k/v [B,S,Kv,D] of a cache cut
    along the sequence -> [B,T,H,D] (f32), the softmax over every rank's
    block."""
    b, t, h, d = q.shape
    qg = q.reshape(b, t, n_kv, h // n_kv, d)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k).to(torch.float32) \
        * d ** -0.5
    e, l = _merged_softmax(_slot_mask(s, kv_len, tp), tp)
    o = coll.all_reduce(torch.einsum("bkgts,bskd->btkgd", e,
                                     v.to(torch.float32)), tp.ctx, tp.axes)
    return (o / l.permute(0, 3, 1, 2, 4)).reshape(b, t, h, -1)


# ---------------------------------------------------------------------------
# MLA block (latent-compressed KV; minicpm3 / deepseek family)
# ---------------------------------------------------------------------------

def mla_init(generator: torch.Generator, cfg: AttnConfig, device) -> dict:
    nh = cfg.n_heads
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim

    def dense(d_in, d_out):
        return dense_init(generator, d_in, d_out, device, bias=False,
                          scale=0.02)

    if cfg.q_lora_rank:
        p = {"w_dq": dense(cfg.d_model, cfg.q_lora_rank)}
        p["q_norm"] = rms_norm_init(cfg.q_lora_rank, device)
        p["w_uq"] = dense(cfg.q_lora_rank, nh * qd)
    else:
        p = {"w_q": dense(cfg.d_model, nh * qd)}
    p["w_dkv"] = dense(cfg.d_model, cfg.kv_lora_rank + cfg.qk_rope_dim)
    p["kv_norm"] = rms_norm_init(cfg.kv_lora_rank, device)
    p["w_uk"] = dense(cfg.kv_lora_rank, nh * cfg.qk_nope_dim)
    p["w_uv"] = dense(cfg.kv_lora_rank, nh * cfg.v_head_dim)
    p["wo"] = dense(nh * cfg.v_head_dim, cfg.d_model)
    return p


def _mla_qkr(p, cfg: AttnConfig, x, positions, nh: int):
    """The queries of ``nh`` heads and the compressed kv: q_nope, q_rope,
    c_kv, k_rope (RoPE applied)."""
    b, t, _ = x.shape
    if cfg.q_lora_rank:
        ql = rms_norm_apply(p["q_norm"], dense_apply(p["w_dq"], x))
        q = dense_apply(p["w_uq"], ql)
    else:
        q = dense_apply(p["w_q"], x)
    q = q.reshape(b, t, nh, cfg.qk_nope_dim + cfg.qk_rope_dim)
    q_nope = q[..., :cfg.qk_nope_dim]
    q_rope = q[..., cfg.qk_nope_dim:]
    dkv = dense_apply(p["w_dkv"], x)
    c_kv = rms_norm_apply(p["kv_norm"], dkv[..., :cfg.kv_lora_rank])
    k_rope = dkv[..., cfg.kv_lora_rank:][:, :, None, :]   # one shared head
    cos, sin = rope_cos_sin(positions, cfg.qk_rope_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope, cos, sin)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def mla_apply(p: dict, cfg: AttnConfig, x: torch.Tensor,
              positions: torch.Tensor, cache: Optional[dict] = None,
              kv_len: Optional[torch.Tensor] = None,
              return_kv: bool = False,
              tp=None) -> Tuple[torch.Tensor, Optional[dict]]:
    b, t, _ = x.shape
    heads, _ = _heads_tp(cfg, tp)
    nh = cfg.n_heads // tp.size if heads else cfg.n_heads
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    q_nope, q_rope, c_kv, k_rope = _mla_qkr(p, cfg, x, positions, nh)

    if cache is None:
        # train / prefill: expanded form, chunked over queries
        k_nope = dense_apply(p["w_uk"], c_kv).reshape(b, t, nh,
                                                      cfg.qk_nope_dim)
        v = dense_apply(p["w_uv"], c_kv).reshape(b, t, nh, cfg.v_head_dim)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            b, t, nh, cfg.qk_rope_dim)], dim=-1)
        out = chunked_attention(q, k, v, nh, cfg.q_chunk, causal=True,
                                scale=scale)
        out = out.reshape(b, t, nh * cfg.v_head_dim)
        kv = {"c_kv": c_kv, "k_rope": k_rope} if return_kv else None
        return dense_apply(p["wo"], out), kv

    # decode: absorbed latent attention against the compressed cache
    pos0 = _pos0(positions)
    _write(cache["c_kv"], c_kv, pos0, tp)
    _write(cache["k_rope"], k_rope, pos0, tp)
    ckv = cache["c_kv"].to(x.dtype)                        # [B,S,R]
    krp = cache["k_rope"].to(x.dtype)                      # [B,S,rope]
    w_uk = p["w_uk"]["w"].reshape(cfg.kv_lora_rank, nh, cfg.qk_nope_dim)
    # absorb: q' = q_nope @ W_uk^T -> latent-space queries [B,T,H,R]
    q_lat = torch.einsum("bthd,rhd->bthr", q_nope, w_uk.to(x.dtype))
    if heads:                        # every head against the rank's slots
        q_lat, q_rope = tp.gather(q_lat, 2), tp.gather(q_rope, 2)
    s = (torch.einsum("bthr,bsr->bhts", q_lat, ckv)
         + torch.einsum("bthd,bsd->bhts", q_rope, krp)).to(torch.float32)
    s = s * scale
    if tp is None:
        sk = ckv.shape[1]
        if kv_len is not None:
            valid = torch.arange(sk, device=s.device)[None, :] \
                < kv_len[:, None]
            s = torch.where(valid[:, None, None], s,
                            torch.tensor(NEG_INF, dtype=torch.float32,
                                         device=s.device))
        att = torch.softmax(s, dim=-1).to(x.dtype)
        ctx = torch.einsum("bhts,bsr->bthr", att, ckv)      # latent context
    else:
        e, l = _merged_softmax(_slot_mask(s, kv_len, tp), tp)
        ctx = coll.all_reduce(torch.einsum("bhts,bsr->bthr", e,
                                           ckv.to(torch.float32)),
                              tp.ctx, tp.axes)
        ctx = (ctx / l.permute(0, 2, 1, 3)).to(x.dtype)
        if heads:
            ctx = tp.block(ctx, 2)
    w_uv = p["w_uv"]["w"].reshape(cfg.kv_lora_rank, nh, cfg.v_head_dim)
    out = torch.einsum("bthr,rhd->bthd", ctx, w_uv.to(x.dtype))
    out = out.reshape(b, t, nh * cfg.v_head_dim)
    return dense_apply(p["wo"], out), cache


def attention_init(generator: torch.Generator, cfg: AttnConfig,
                   device) -> dict:
    return (mla_init if cfg.kind == "mla" else gqa_init)(generator, cfg,
                                                         device)


def attention_apply(p, cfg: AttnConfig, x, positions, cache=None,
                    kv_len=None, return_kv=False, tp=None):
    fn = mla_apply if cfg.kind == "mla" else gqa_apply
    return fn(p, cfg, x, positions, cache=cache, kv_len=kv_len,
              return_kv=return_kv, tp=tp)


def init_cache(cfg: AttnConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Zeroed decode buffers on ``device`` (default ``cuda``: raises
    without a card); MLA takes no int8 (bf16 instead)."""
    device = resolve_device(device)
    if cfg.kind == "mla":
        d = torch.bfloat16 if dtype == torch.int8 else dtype
        return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                    dtype=d, device=device),
                "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                      dtype=d, device=device)}
    shp = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    if dtype == torch.int8:
        return {"k": torch.zeros(shp, dtype=torch.int8, device=device),
                "v": torch.zeros(shp, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shp[:-1], dtype=torch.float32,
                                       device=device),
                "v_scale": torch.zeros(shp[:-1], dtype=torch.float32,
                                       device=device)}
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}
