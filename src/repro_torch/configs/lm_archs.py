"""The LM architectures: the JAX package's five (a port of
``repro.configs.lm_archs``: the same full and smoke configs) and
``moonlight-16b-a3b``, which only the port registers (it is not among
``ARCH_IDS``, the JAX package's ids).

``embedding="robe"`` applies the paper's technique to the token-embedding
table; default compression 8× (vocab tables are denser in information
than recsys tables).  ``embedding="full"`` is the baseline.
"""

from __future__ import annotations

import torch

from repro_torch.configs.registry import ArchBundle, LM_SHAPES, register
from repro_torch.models.transformer import TransformerConfig


def _robe_size(vocab: int, d_model: int, compression: int) -> int:
    return max(4096, vocab * d_model // compression)


def _lm_bundle(arch_id: str, full_kw: dict, smoke_kw: dict,
               notes: str = "") -> ArchBundle:
    def make_config(variant: str = "full", embedding: str = "full",
                    robe_compression: int = 8, **over):
        kw = dict(full_kw if variant == "full" else smoke_kw)
        kw.update(over)
        kw.setdefault("name", f"{arch_id}-{variant}")
        if embedding == "robe":
            kw["embedding"] = "robe"
            kw["robe_size"] = _robe_size(kw["vocab"], kw["d_model"],
                                         robe_compression)
            kw.setdefault("robe_block", 32)
        return TransformerConfig(**kw)

    return register(ArchBundle(arch_id=arch_id, kind="lm", shapes=LM_SHAPES,
                               make_config=make_config, notes=notes))


# --- kimi-k2-1t-a32b [moe] 61L d7168 64H (GQA kv=8) d_ff=2048 (expert)
#     vocab 163840, MoE 384e top-8 (+1 shared, first layer dense @18432) ----
_lm_bundle(
    "kimi-k2-1t-a32b",
    full_kw=dict(
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
        d_ff=2048, vocab=163840, qk_norm=False, rope_theta=5e4,
        n_experts=384, top_k=8, n_shared=1, first_k_dense=1,
        d_ff_dense=18432, moe_dispatch="ep", q_chunk=512),
    smoke_kw=dict(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab=512, n_experts=8, top_k=2, n_shared=1,
        first_k_dense=1, d_ff_dense=96, moe_dispatch="dense", q_chunk=8,
        compute_dtype=torch.float32, remat=False),
    notes="1T-param MoE; FSDP over the data axis required.")

# --- qwen3-moe-30b-a3b [moe] 48L d2048 32H (GQA kv=4) d_ff=768 (expert)
#     vocab 151936, MoE 128e top-8, qk-norm ------------------------------
_lm_bundle(
    "qwen3-moe-30b-a3b",
    full_kw=dict(
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=768, vocab=151936, qk_norm=True, rope_theta=1e6,
        n_experts=128, top_k=8, moe_dispatch="ep", q_chunk=512),
    smoke_kw=dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab=512, qk_norm=True, n_experts=8, top_k=2,
        moe_dispatch="dense", q_chunk=8, compute_dtype=torch.float32,
        remat=False))

# --- minicpm3-4b [dense] 62L d2560 40H d_ff 6400 vocab 73448 — MLA -------
_lm_bundle(
    "minicpm3-4b",
    full_kw=dict(
        n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
        d_ff=6400, vocab=73448, attn_kind="mla", q_lora_rank=768,
        kv_lora_rank=256, qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
        rope_theta=1e4, q_chunk=512),
    smoke_kw=dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=512, attn_kind="mla", q_lora_rank=32,
        kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        q_chunk=8, compute_dtype=torch.float32, remat=False),
    notes="MLA latent-KV attention; 40 heads.")

# --- qwen3-0.6b [dense] 28L d1024 16H (GQA kv=8) d_ff 3072 — qk-norm -----
_lm_bundle(
    "qwen3-0.6b",
    full_kw=dict(
        n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128,
        d_ff=3072, vocab=151936, qk_norm=True, rope_theta=1e6, q_chunk=512),
    smoke_kw=dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, qk_norm=True, q_chunk=8,
        compute_dtype=torch.float32, remat=False))

# --- qwen1.5-32b [dense] 64L d5120 40H (MHA kv=40) d_ff 27392 — QKV bias --
_lm_bundle(
    "qwen1.5-32b",
    full_kw=dict(
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, head_dim=128,
        d_ff=27392, vocab=152064, qkv_bias=True, rope_theta=1e6,
        q_chunk=512),
    smoke_kw=dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=512, qkv_bias=True, q_chunk=8,
        compute_dtype=torch.float32, remat=False),
    notes="MHA (kv=40): the largest KV cache of the set; an int8 cache "
          "halves a bf16 one.")

# --- moonlight-16b-a3b [moe] 27L d2048 16H MLA (no q down-projection,
#     kv_lora 512, nope 128, rope 64, v 128), first layer dense @11264,
#     MoE 64e top-6 of 1408 + 2 shared, sigmoid noaux_tc × 2.446 ---------
_lm_bundle(
    "moonlight-16b-a3b",
    full_kw=dict(
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=1408, vocab=163840, attn_kind="mla", q_lora_rank=0,
        kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        rope_theta=5e4, n_experts=64, top_k=6, n_shared=2, first_k_dense=1,
        d_ff_dense=11264, moe_dispatch="ep", moe_scoring="sigmoid",
        routed_scale=2.446, norm_eps=1e-5, q_chunk=512,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
        cache_dtype=torch.bfloat16),
    smoke_kw=dict(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=32, vocab=512, attn_kind="mla", q_lora_rank=0, kv_lora_rank=16,
        qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, rope_theta=5e4,
        n_experts=8, top_k=2, n_shared=1, first_k_dense=1, d_ff_dense=96,
        moe_dispatch="ep", moe_scoring="sigmoid", routed_scale=2.446,
        norm_eps=1e-5, q_chunk=8, compute_dtype=torch.float32,
        cache_dtype=torch.float32, remat=False),
    notes="Moonlight-16B-A3B (huggingface.co/moonshotai/Moonlight-16B-A3B, "
          "config.json, model_type deepseek_v3): MLA with q_lora_rank "
          "null, sigmoid noaux_tc routing with one group, RMSNorm eps "
          "1e-5 (kv_norm keeps DeepSeek-V3's 1e-6).  The full config holds "
          "bf16 params (62.7 GB in f32); one card takes it whole.  The "
          "router's aux loss is the softmax bundles' Switch form over the "
          "sigmoid scores normalised per token; serving discards it.")
