"""Decoder-only LM family (PyTorch port of ``repro.models.transformer``),
covering the five registered architectures on one device.

One parameterised model: GQA or MLA attention, dense-SwiGLU or MoE FFN,
qk-norm / qkv-bias options, and an optional ROBE-compressed token
embedding (the paper's technique applied to the LM vocabulary table).

Parameters keep the JAX package's tree: the scanned layers stacked along a
leading L dim (``params["layers"]``), the ``first_k_dense`` leading layers
unrolled (``params["dense_layers"]``).  The layers run in a Python loop
over the stacked leaves; ``remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``); ``scan_layers`` is kept for the config's
sake and changes nothing here.

On the card the ROBE token embedding runs in the Hopper kernels of
``kernels/ops.py`` (``robe_lookup`` and its backward), every token one
item of one field; everything else is plain PyTorch.  Under an active
``repro_torch.dist`` context every entry point raises: the sharded LM
(tensor, expert and sequence parallelism) is ROADMAP item 7b.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.robe import RobeSpec, init_memory
from repro_torch.dist import api as dist
from repro_torch.kernels import ops
from repro_torch.nn.attention import (AttnConfig, attention_apply,
                                      attention_init)
from repro_torch.nn.attention import init_cache as attn_init_cache
from repro_torch.nn.core import normal_init, rms_norm_apply, rms_norm_init
from repro_torch.nn.moe import MoeConfig, moe_apply_dense, moe_init
from repro_torch.tree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int                        # dense-FFN hidden (per-expert if MoE)
    vocab: int
    attn_kind: str = "gqa"           # "gqa" | "mla"
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    q_chunk: int = 512
    # MLA dims
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    first_k_dense: int = 0
    d_ff_dense: int = 0              # hidden of the unrolled dense layers
    moe_dispatch: str = "dense"      # "ep" runs dense on one device
    capacity_factor: float = 1.25
    # embedding compression (the paper's technique)
    embedding: str = "full"          # "full" | "robe"
    robe_size: int = 0
    robe_block: int = 32
    # numerics / memory
    compute_dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True
    scan_layers: bool = True
    cache_dtype: Any = torch.bfloat16

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 512 (the JAX package's mesh
        padding, kept so its params load leaf for leaf); the loss masks
        the padded logits."""
        if self.vocab < 4096:
            return self.vocab          # smoke configs: keep exact
        return ((self.vocab + 511) // 512) * 512

    def attn_cfg(self) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            kind=self.attn_kind, qk_norm=self.qk_norm,
            qkv_bias=self.qkv_bias, rope_theta=self.rope_theta,
            q_chunk=self.q_chunk, q_lora_rank=self.q_lora_rank,
            kv_lora_rank=self.kv_lora_rank, qk_nope_dim=self.qk_nope_dim,
            qk_rope_dim=self.qk_rope_dim, v_head_dim=self.v_head_dim)

    def moe_cfg(self) -> MoeConfig:
        return MoeConfig(d_model=self.d_model, d_ff=self.d_ff,
                         n_experts=self.n_experts, top_k=self.top_k,
                         n_shared=self.n_shared,
                         capacity_factor=self.capacity_factor,
                         dispatch=self.moe_dispatch)

    def robe_spec(self) -> RobeSpec:
        return RobeSpec(size=self.robe_size, block_size=self.robe_block,
                        seed=17)

    def param_count(self) -> int:
        """Total parameters (for 6·N·D model-flops accounting)."""
        d, f = self.d_model, self.d_ff
        if self.attn_kind == "mla":
            qd = self.qk_nope_dim + self.qk_rope_dim
            attn = (d * self.q_lora_rank + self.q_lora_rank * self.n_heads * qd
                    + d * (self.kv_lora_rank + self.qk_rope_dim)
                    + self.kv_lora_rank * self.n_heads
                    * (self.qk_nope_dim + self.v_head_dim)
                    + self.n_heads * self.v_head_dim * d)
        else:
            attn = d * self.head_dim * (self.n_heads * 2
                                        + self.n_kv_heads * 2)
        if self.is_moe:
            ffn = 3 * d * f * self.n_experts + d * self.n_experts \
                + 3 * d * f * self.n_shared
            dense_layers = self.first_k_dense
            moe_layers = self.n_layers - dense_layers
            per = attn * self.n_layers + ffn * moe_layers \
                + 3 * d * self.d_ff_dense * dense_layers
        else:
            per = (attn + 3 * d * f) * self.n_layers
        return per + 2 * self.vocab * d   # embed + head

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top-k + shared only)."""
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        attn = self.param_count() - (3 * d * f * self.n_experts
                                     + d * self.n_experts) \
            * (self.n_layers - self.first_k_dense) - 2 * self.vocab * d
        act_ffn = 3 * d * f * self.top_k * (self.n_layers
                                            - self.first_k_dense)
        return attn + act_ffn + 2 * self.vocab * d


def _no_mesh(what: str) -> None:
    if dist.current() is not None:
        raise NotImplementedError(
            f"transformer.{what} under a mesh: the sharded LM (tensor, "
            f"expert and sequence parallelism) is ROADMAP item 7b")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _dense_ffn_init(generator, d: int, f: int, device) -> dict:
    return {"w_gate": normal_init(generator, (d, f), device, 0.02),
            "w_up": normal_init(generator, (d, f), device, 0.02),
            "w_down": normal_init(generator, (f, d), device, 0.02)}


def _dense_ffn_apply(p, x):
    h = torch.nn.functional.silu(x @ p["w_gate"].to(x.dtype)) \
        * (x @ p["w_up"].to(x.dtype))
    return h @ p["w_down"].to(x.dtype)


def _layer_init(generator, cfg: TransformerConfig, moe: bool,
                device) -> dict:
    p = {"attn_norm": rms_norm_init(cfg.d_model, device),
         "ffn_norm": rms_norm_init(cfg.d_model, device),
         "attn": attention_init(generator, cfg.attn_cfg(), device)}
    if moe:
        p["moe"] = moe_init(generator, cfg.moe_cfg(), device)
    else:
        f = cfg.d_ff_dense if (cfg.is_moe and cfg.d_ff_dense) else cfg.d_ff
        p["ffn"] = _dense_ffn_init(generator, cfg.d_model, f, device)
    return p


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device) -> dict:
    """Random parameters in the JAX package's tree, drawn from
    ``generator`` in the order of its keys (embedding, the layers, the
    head), the scanned layers stacked along a leading L dim."""
    params: dict = {}
    if cfg.embedding == "robe":
        params["embed"] = {"memory": init_memory(generator, cfg.robe_spec(),
                                                 device)}
    else:
        params["embed"] = {"table": normal_init(
            generator, (cfg.vocab_padded, cfg.d_model), device, 0.02)}
    if cfg.first_k_dense:
        params["dense_layers"] = [
            _layer_init(generator, cfg, False, device)
            for _ in range(cfg.first_k_dense)]
    stack = [_layer_init(generator, cfg, cfg.is_moe, device)
             for _ in range(n_scanned(cfg))]
    params["layers"] = tree_map(lambda *xs: torch.stack(xs), *stack)
    del stack
    params["final_norm"] = rms_norm_init(cfg.d_model, device)
    params["lm_head"] = normal_init(generator, (cfg.d_model,
                                                cfg.vocab_padded), device,
                                    0.02)
    if cfg.param_dtype != torch.float32:
        params = tree_map(lambda x: x.to(cfg.param_dtype), params)
    return params


def n_scanned(cfg: TransformerConfig) -> int:
    return cfg.n_layers - cfg.first_k_dense


def layer_params(params: dict) -> list:
    """Each scanned layer's params: views into the stacked leaves, cut by
    ``unbind`` (whose backward stacks the layers' gradients in one
    pass)."""
    stacked = params["layers"]
    cols = [a.unbind(0) for a in leaves(stacked)]
    return [unflatten(stacked, [c[i] for c in cols])
            for i in range(len(cols[0]))]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _embed(params, cfg: TransformerConfig,
           tokens: torch.Tensor) -> torch.Tensor:
    if cfg.embedding == "robe":
        # every token one item of one field (table 0): the backward's
        # buckets stay one field wide
        b, t = tokens.shape
        rows = tokens.reshape(b * t, 1).to(torch.int32).contiguous()
        x = ops.robe_lookup(params["embed"]["memory"], rows, (0,),
                            cfg.d_model, cfg.robe_spec())
        return x.reshape(b, t, cfg.d_model).to(cfg.compute_dtype)
    x = params["embed"]["table"][tokens.long()]
    return x.to(cfg.compute_dtype)


def _moe_block(p, cfg: TransformerConfig, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,T,d] -> (y, aux); one device: the dense dispatch."""
    b, t, d = x.shape
    y, aux = moe_apply_dense(p, cfg.moe_cfg(), x.reshape(b * t, d))
    return y.reshape(b, t, d), aux


def _layer_apply(p, cfg: TransformerConfig, moe: bool, x, positions,
                 collect_kv: bool = False):
    h, kv = attention_apply(p["attn"], cfg.attn_cfg(),
                            rms_norm_apply(p["attn_norm"], x), positions,
                            return_kv=collect_kv)
    x = x + h
    hin = rms_norm_apply(p["ffn_norm"], x)
    if moe:
        h, aux = _moe_block(p["moe"], cfg, hin)
    else:
        h = _dense_ffn_apply(p["ffn"], hin)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + h, aux, kv


def _stack_kv(kvs: list):
    if not kvs or kvs[0] is None:
        return None
    return {k: torch.stack([kv[k] for kv in kvs]) for k in kvs[0]}


def forward(params, cfg: TransformerConfig, tokens: torch.Tensor,
            collect_cache: bool = False, logits_mode: str = "all"):
    """tokens [B,T] -> (logits, aux[, cache]).

    logits_mode: "all" ([B,T,V], training) | "last" ([B,V], prefill
    serving).  ``collect_cache``: also the prefill's keys and values,
    {"layers": stacked [L, B, T, ...], "dense_layers": [...]}."""
    _no_mesh("forward")
    x = _embed(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    dense_kv = []
    for p in params.get("dense_layers", []):
        x, aux, kv = _layer_apply(p, cfg, False, x, positions, collect_cache)
        aux_total = aux_total + aux
        dense_kv.append(kv)

    def body(layer_p, xx):
        return _layer_apply(layer_p, cfg, cfg.is_moe, xx, positions,
                            collect_cache)

    remat = cfg.remat and torch.is_grad_enabled()
    kvs = []
    for layer_p in layer_params(params):
        if remat:
            x, aux, kv = checkpoint(body, layer_p, x, use_reentrant=False)
        else:
            x, aux, kv = body(layer_p, x)
        aux_total = aux_total + aux
        kvs.append(kv)
    x = rms_norm_apply(params["final_norm"], x)
    if logits_mode == "last":
        x = x[:, -1]
    logits = x @ params["lm_head"].to(x.dtype)
    if collect_cache:
        cache = {"layers": _stack_kv(kvs)}
        if dense_kv:
            cache["dense_layers"] = dense_kv
        return logits, aux_total, cache
    return logits, aux_total


def cross_entropy(cfg: TransformerConfig, logits: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy of ``logits`` [..., V].  The logits
    stay in the compute dtype (the padded vocabulary masked to -1e30);
    only the max-shifted exp and sum run in f32."""
    lg = logits
    if cfg.vocab_padded != cfg.vocab:
        real = torch.arange(lg.shape[-1], device=lg.device) < cfg.vocab
        lg = torch.where(real, lg, torch.tensor(-1e30, dtype=lg.dtype,
                                                device=lg.device))
    m = lg.detach().amax(dim=-1, keepdim=True).to(torch.float32)
    ex = torch.exp(lg.to(torch.float32) - m)
    lse = torch.log(torch.sum(ex, dim=-1)) + m[..., 0]
    gold = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    return (lse - gold.to(torch.float32)).mean()


def loss_fn(params, cfg: TransformerConfig, batch: dict
            ) -> Tuple[torch.Tensor, dict]:
    """``cross_entropy`` of the forward's logits + 0.001 · the MoE aux
    loss."""
    _no_mesh("loss_fn")
    logits, aux = forward(params, cfg, batch["tokens"])
    ce = cross_entropy(cfg, logits, batch["labels"])
    return ce + 0.001 * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Zeroed decode caches in ``cfg.cache_dtype``: the scanned layers'
    stacked [L, B, max_len, ...], the dense layers' a list."""
    def one(lead=()):
        c = attn_init_cache(cfg.attn_cfg(), 1, 1, cfg.cache_dtype, "meta")
        return {k: torch.zeros(lead + (batch, max_len) + tuple(v.shape[2:]),
                               dtype=v.dtype, device=device)
                for k, v in c.items()}

    caches = {"layers": one((n_scanned(cfg),))}
    if cfg.first_k_dense:
        caches["dense_layers"] = [one() for _ in range(cfg.first_k_dense)]
    return caches


def _layer_decode(p, cfg: TransformerConfig, moe: bool, x, cache, pos: int,
                  kv_len):
    positions = torch.full((x.shape[1],), pos, dtype=torch.int32,
                           device=x.device)
    h, cache = attention_apply(p["attn"], cfg.attn_cfg(),
                               rms_norm_apply(p["attn_norm"], x), positions,
                               cache=cache, kv_len=kv_len)
    x = x + h
    hin = rms_norm_apply(p["ffn_norm"], x)
    if moe:
        h, _ = _moe_block(p["moe"], cfg, hin)
    else:
        h = _dense_ffn_apply(p["ffn"], hin)
    return x + h, cache


def decode_step(params, cfg: TransformerConfig, caches, tokens: torch.Tensor,
                pos) -> Tuple[torch.Tensor, Any]:
    """One decode step: tokens [B,1] at position ``pos`` with a cache filled
    up to ``pos``.  Writes the step's keys and values into ``caches`` at
    ``pos`` (in place) and returns (logits [B,V], caches)."""
    _no_mesh("decode_step")
    pos = int(pos)
    b = tokens.shape[0]
    x = _embed(params, cfg, tokens)
    kv_len = torch.full((b,), pos + 1, dtype=torch.int32, device=x.device)
    for p, c in zip(params.get("dense_layers", []),
                    caches.get("dense_layers", [])):
        x, _ = _layer_decode(p, cfg, False, x, c, pos, kv_len)
    for i, layer_p in enumerate(layer_params(params)):
        layer_c = {k: v[i] for k, v in caches["layers"].items()}
        x, _ = _layer_decode(layer_p, cfg, cfg.is_moe, x, layer_c, pos,
                             kv_len)
    x = rms_norm_apply(params["final_norm"], x)
    logits = x[:, -1] @ params["lm_head"].to(x.dtype)
    return logits, caches
