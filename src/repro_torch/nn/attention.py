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
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

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
    # MLA dims (minicpm3 / deepseek-style)
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


def _write(buf: torch.Tensor, val: torch.Tensor, pos0: int) -> None:
    """The cache's ``dynamic_update_slice`` at ``pos0`` along dim 1, in
    place."""
    t = val.shape[1]
    if pos0 < 0 or pos0 + t > buf.shape[1]:
        raise ValueError(f"cache write at {pos0}..{pos0 + t} outside its "
                         f"{buf.shape[1]} slots")
    buf[:, pos0:pos0 + t] = val.to(buf.dtype)


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
              return_kv: bool = False) -> Tuple[torch.Tensor, Optional[dict]]:
    """x [B,T,D].  ``cache`` = {"k", "v"} [B,S,Kv,hd] (+ "k_scale",
    "v_scale" [B,S,Kv] for an int8 cache): decode; the new keys and values
    are written at ``positions[0]``.  ``return_kv`` (prefill): also return
    the sequence's {"k", "v"}."""
    b, t, _ = x.shape
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = dense_apply(p["wq"], x).reshape(b, t, nh, hd)
    k = dense_apply(p["wk"], x).reshape(b, t, nkv, hd)
    v = dense_apply(p["wv"], x).reshape(b, t, nkv, hd)
    if cfg.qk_norm:
        q = rms_norm_apply(p["q_norm"], q)
        k = rms_norm_apply(p["k_norm"], k)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache is not None:
        pos0 = _pos0(positions)
        if "k_scale" in cache:
            qk, sk = _q8(k.to(torch.float32))
            qv, sv = _q8(v.to(torch.float32))
            _write(cache["k"], qk, pos0)
            _write(cache["v"], qv, pos0)
            _write(cache["k_scale"], sk, pos0)
            _write(cache["v_scale"], sv, pos0)
            kf = (cache["k"].to(x.dtype)
                  * cache["k_scale"][..., None].to(x.dtype))
            vf = (cache["v"].to(x.dtype)
                  * cache["v_scale"][..., None].to(x.dtype))
        else:
            _write(cache["k"], k, pos0)
            _write(cache["v"], v, pos0)
            kf = cache["k"].to(x.dtype)
            vf = cache["v"].to(x.dtype)
        out = chunked_attention(q, kf, vf, nkv, 0, causal=False,
                                kv_len=kv_len)
    else:
        out = chunked_attention(q, k, v, nkv, cfg.q_chunk, causal=True)
        if return_kv:
            cache = {"k": k, "v": v}
    out = out.reshape(b, t, nh * hd)
    return dense_apply(p["wo"], out), cache


# ---------------------------------------------------------------------------
# MLA block (latent-compressed KV; minicpm3 / deepseek family)
# ---------------------------------------------------------------------------

def mla_init(generator: torch.Generator, cfg: AttnConfig, device) -> dict:
    nh = cfg.n_heads
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim

    def dense(d_in, d_out):
        return dense_init(generator, d_in, d_out, device, bias=False,
                          scale=0.02)

    p = {"w_dq": dense(cfg.d_model, cfg.q_lora_rank)}
    p["q_norm"] = rms_norm_init(cfg.q_lora_rank, device)
    p["w_uq"] = dense(cfg.q_lora_rank, nh * qd)
    p["w_dkv"] = dense(cfg.d_model, cfg.kv_lora_rank + cfg.qk_rope_dim)
    p["kv_norm"] = rms_norm_init(cfg.kv_lora_rank, device)
    p["w_uk"] = dense(cfg.kv_lora_rank, nh * cfg.qk_nope_dim)
    p["w_uv"] = dense(cfg.kv_lora_rank, nh * cfg.v_head_dim)
    p["wo"] = dense(nh * cfg.v_head_dim, cfg.d_model)
    return p


def _mla_qkr(p, cfg: AttnConfig, x, positions):
    """The queries and the compressed kv: q_nope, q_rope, c_kv, k_rope
    (RoPE applied)."""
    b, t, _ = x.shape
    nh = cfg.n_heads
    ql = rms_norm_apply(p["q_norm"], dense_apply(p["w_dq"], x))
    q = dense_apply(p["w_uq"], ql).reshape(
        b, t, nh, cfg.qk_nope_dim + cfg.qk_rope_dim)
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
              return_kv: bool = False) -> Tuple[torch.Tensor, Optional[dict]]:
    b, t, _ = x.shape
    nh = cfg.n_heads
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    q_nope, q_rope, c_kv, k_rope = _mla_qkr(p, cfg, x, positions)

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
    _write(cache["c_kv"], c_kv, pos0)
    _write(cache["k_rope"], k_rope, pos0)
    ckv = cache["c_kv"].to(x.dtype)                        # [B,S,R]
    krp = cache["k_rope"].to(x.dtype)                      # [B,S,rope]
    w_uk = p["w_uk"]["w"].reshape(cfg.kv_lora_rank, nh, cfg.qk_nope_dim)
    # absorb: q' = q_nope @ W_uk^T -> latent-space queries [B,T,H,R]
    q_lat = torch.einsum("bthd,rhd->bthr", q_nope, w_uk.to(x.dtype))
    s = (torch.einsum("bthr,bsr->bhts", q_lat, ckv)
         + torch.einsum("bthd,bsd->bhts", q_rope, krp)).to(torch.float32)
    s = s * scale
    sk = ckv.shape[1]
    if kv_len is not None:
        valid = torch.arange(sk, device=s.device)[None, :] < kv_len[:, None]
        s = torch.where(valid[:, None, None], s,
                        torch.tensor(NEG_INF, dtype=torch.float32,
                                     device=s.device))
    att = torch.softmax(s, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhts,bsr->bthr", att, ckv)          # latent context
    w_uv = p["w_uv"]["w"].reshape(cfg.kv_lora_rank, nh, cfg.v_head_dim)
    out = torch.einsum("bthr,rhd->bthd", ctx, w_uv.to(x.dtype))
    out = out.reshape(b, t, nh * cfg.v_head_dim)
    return dense_apply(p["wo"], out), cache


def attention_init(generator: torch.Generator, cfg: AttnConfig,
                   device) -> dict:
    return (mla_init if cfg.kind == "mla" else gqa_init)(generator, cfg,
                                                         device)


def attention_apply(p, cfg: AttnConfig, x, positions, cache=None,
                    kv_len=None, return_kv=False):
    fn = mla_apply if cfg.kind == "mla" else gqa_apply
    return fn(p, cfg, x, positions, cache=cache, kv_len=kv_len,
              return_kv=return_kv)


def init_cache(cfg: AttnConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Zeroed decode buffers; MLA takes no int8 (bf16 instead)."""
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
