"""Architecture ``moonlight``: Moonlight-16B-A3B (DeepSeek-V3's block:
latent attention without a q down-projection, a dense first layer, then
layers of 64 routed experts, 6 a token, and 2 shared), its token table a
ROBE array.  The configuration's keys are those of the published
``config.json``; ``init`` gives the scales of the random weights.

The weights are the benchmark's own draws, in the program's tree (the
port's ``models.transformer``: ``embed.memory``, ``dense_layers``, the
MoE layers stacked along a leading L dim in ``layers``, ``final_norm``,
``lm_head``), made in place on the device in the configuration's dtype:
each leaf is allocated once, whole, and filled by one draw, so the peak is
the weights themselves (31.3 GB in bf16).  The reference makes them again
from the same seed.
"""

from __future__ import annotations

import torch

REFERENCE = "moonlight"
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _attn(cfg: dict) -> dict:
    d, h, r = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["kv_lora_rank"]
    nope, rope, v = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                     cfg["v_head_dim"])
    return {"w_q": {"w": (d, h * (nope + rope))},
            "w_dkv": {"w": (d, r + rope)}, "kv_norm": {"g": (r,)},
            "w_uk": {"w": (r, h * nope)}, "w_uv": {"w": (r, h * v)},
            "wo": {"w": (h * v, d)}}


def _ffn(d: int, f: int) -> dict:
    return {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}


def shapes(cfg: dict) -> dict:
    """The shape of every leaf of the program's tree."""
    d, e, f = (cfg["hidden_size"], cfg["n_routed_experts"],
               cfg["moe_intermediate_size"])
    n_dense = cfg["first_k_dense_replace"]
    n_moe = cfg["num_hidden_layers"] - n_dense

    def layer(moe: bool, lead: tuple = ()) -> dict:
        p = {"attn_norm": {"g": (d,)}, "ffn_norm": {"g": (d,)},
             "attn": _attn(cfg)}
        if moe:
            p["moe"] = {"router": (d, e), "w_gate": (e, d, f),
                        "w_up": (e, d, f), "w_down": (e, f, d),
                        "shared": _ffn(d, f * cfg["n_shared_experts"]),
                        "score_bias": (e,)}
        else:
            p["ffn"] = _ffn(d, cfg["intermediate_size"])
        return _lead(p, lead)

    return {"embed": {"memory": (cfg["robe_size"],)},
            "dense_layers": [layer(False) for _ in range(n_dense)],
            "layers": layer(True, (n_moe,)),
            "final_norm": {"g": (d,)},
            "lm_head": (d, cfg["vocab_size"])}


def _lead(tree, lead: tuple):
    if isinstance(tree, dict):
        return {k: _lead(v, lead) for k, v in tree.items()}
    return lead + tuple(tree)


def _fill(path: tuple, shape: tuple, cfg: dict, gen, device):
    """One leaf, drawn in place: norm weights 1; ``score_bias`` f32 normal
    of ``score_bias_std``; ROBE slots normal of ``memory_std``; every
    weight [.., d_in, d_out] normal of std gain · d_in^-1/2, the gain
    ``out_gain`` for the blocks' output projections (attention's ``wo``,
    every SwiGLU's ``w_down``), ``lm_head_gain`` for the head and 1 for
    the rest."""
    init, name = cfg["init"], path[-1]
    dt = DTYPES[cfg["param_dtype"]]
    if name == "g":
        return torch.ones(shape, dtype=dt, device=device)
    if name == "score_bias":
        x = torch.empty(shape, dtype=torch.float32, device=device)
        return x.normal_(generator=gen).mul_(init["score_bias_std"])
    x = torch.empty(shape, dtype=dt, device=device).normal_(generator=gen)
    if name == "memory":
        return x.mul_(init["memory_std"])
    gain = (init["lm_head_gain"] if name == "lm_head" else
            init["out_gain"] if "wo" in path or name == "w_down" else 1.0)
    return x.mul_(gain * shape[-2] ** -0.5)


def make_params(cfg: dict, seed: int, device) -> dict:
    """The configuration's weights for ``seed`` on ``device``, leaf by leaf
    in the tree's key order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, path) for v in tree]
        return _fill(path, tree, cfg, gen, device)

    return walk(shapes(cfg))


def decode_flops(cfg: dict) -> int:
    """FLOPs a decoded token makes through the weights: each layer's
    projections in the absorbed form (q, the compressed kv, W_uk into the
    latent queries, W_uv out of the latent context, the output), the
    dense layers' SwiGLU, each MoE layer's router, its 6 routed and its
    shared experts, and the head; 2 a multiply-add."""
    d, h, r = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["kv_lora_rank"]
    nope, rope, v = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                     cfg["v_head_dim"])
    e, f, k = (cfg["n_routed_experts"], cfg["moe_intermediate_size"],
               cfg["num_experts_per_tok"])
    n_dense = cfg["first_k_dense_replace"]
    n_moe = cfg["num_hidden_layers"] - n_dense
    attn = (d * h * (nope + rope) + d * (r + rope) + r * h * nope
            + r * h * v + h * v * d)
    dense = 3 * d * cfg["intermediate_size"]
    moe = d * e + 3 * d * f * (k + cfg["n_shared_experts"])
    return 2 * (cfg["num_hidden_layers"] * attn + n_dense * dense
                + n_moe * moe + d * cfg["vocab_size"])


def key_flops(cfg: dict) -> int:
    """FLOPs a decoded token makes for each position of its cache in the
    absorbed attention: every layer and head, its latent query against the
    cached c_kv and k_rope (2·576) and its weights over c_kv (2·512)."""
    r, rope = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
    return (cfg["num_hidden_layers"] * cfg["num_attention_heads"]
            * (2 * (r + rope) + 2 * r))


def model_flops(cfg: dict) -> dict:
    return {"decode": decode_flops(cfg), "decode_per_key": key_flops(cfg)}


def touched(cfg: dict, unit: dict, device) -> int:
    """The ROBE slots the step's token ids reach: every token one row of
    table 0, ``hidden_size`` wide."""
    from reference.robe_hash import Robe
    robe = Robe(size=cfg["robe_size"], block=cfg["robe_block"],
                seed=cfg["robe_seed"])
    rows = torch.as_tensor(unit["tokens"]).to(device)[:, None]
    return robe.touched(rows, cfg["hidden_size"])
