"""Moonlight-16B-A3B's forward pass in plain PyTorch, float32: the plain
reference that the benchmark's output check and the port's CPU tests
(``tests/test_torch_moonlight.py``) hold the ``moonlight-16b-a3b`` bundle
to.  The token table may be a ROBE array (configuration key ``embedding``
"robe"), hashed by ``reference/robe_hash.py``.

It follows DeepSeek-V3's published modeling code (``modeling_deepseek.py``
of the ``deepseek_v3`` model type, which Moonlight's ``config.json``
names), for the case that config gives:

* the embedding, then ``num_hidden_layers`` decoder layers, each
  ``x + attn(rms_norm(x))`` then ``x + mlp(rms_norm(x))``, a final RMS norm
  and an untied head; RMS norms of ``rms_norm_eps`` but the latent kv
  norm, which DeepSeek-V3's code builds with its class default of 1e-6;
* latent attention (MLA) with ``q_lora_rank`` null: q from one projection
  of the hidden state, the compressed kv and the shared rope key from
  ``kv_a_proj_with_mqa``, the kv norm, the per-head nope keys and values
  from the latent, RoPE on the rope parts, softmax of q·k over
  sqrt(nope + rope) with the causal mask, in float32;
* the first ``first_k_dense_replace`` layers a SwiGLU of
  ``intermediate_size``, every later one an MoE: the ``noaux_tc`` gate
  (sigmoid scores; the experts chosen by the top ``num_experts_per_tok``
  of the scores plus ``e_score_correction_bias`` within the top
  ``topk_group`` of ``n_group`` groups, each group scored by the sum of its
  two best; the weights the chosen sigmoid scores, divided by their sum
  plus 1e-20 when ``norm_topk_prob``, times ``routed_scaling_factor``),
  each chosen expert's SwiGLU of ``moe_intermediate_size`` weighted and
  summed, plus the shared experts as one SwiGLU of
  ``moe_intermediate_size · n_shared_experts``.

Departures, none of which changes the function computed on given weights
but the first:

* RoPE rotates the two halves of each rope part together; DeepSeek's
  checkpoints interleave the pairs (its ``apply_rotary_pos_emb`` first
  de-interleaves them).  On random weights that is a fixed permutation of
  the rope columns of ``q_proj`` and ``kv_a_proj_with_mqa``.
* The weights come in the port's tree and layout (``[d_in, d_out]``;
  ``kv_b_proj`` as the per-head key part ``w_uk`` and value part
  ``w_uv``; the experts stacked ``[E, ...]``; the scanned layers stacked
  along a leading L dim), read one layer at a time and upcast to float32.
* Attention runs in blocks of ``block`` query positions, so that a long
  sequence fits; the MoE runs each expert over the tokens that chose it.
* With ``embedding`` "robe" the token table is the paper's ROBE array
  (arXiv:2108.02191): every token one row of table 0, ``robe_size``
  slots, block ``robe_block``, hash seed ``robe_seed``.

No kernel, cache or batch: one sequence of token ids in, the logits at
the positions asked for out.  ``replay`` takes the experts every MoE layer
is to use (a program's own choices, so that a near-tie that rounding
decided otherwise does not part the two forwards) and counts, position by
position, the choices its own gate would have made otherwise;
``first_latent`` gives what the first layer's latent cache holds.  It
imports nothing of the port and nothing of JAX.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, ..., D] rotated at positions ``pos`` [T], halves together."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = pos.to(torch.float32)[:, None] * inv                 # [T, D/2]
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (d // 2,)
    c, s = torch.cos(ang).view(shape), torch.sin(ang).view(shape)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def swiglu(x: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    return (torch.nn.functional.silu(x @ wg) * (x @ wu)) @ wd


def latent(p: dict, cfg: dict, x: torch.Tensor):
    """What latent attention keeps a position of ``x`` [T, d] (the input
    after the attention norm): the normed compressed kv [T, kv_lora_rank]
    and the shared rope key, rotated [T, qk_rope_head_dim]."""
    r = cfg["kv_lora_rank"]
    ckv = x @ p["w_dkv"]["w"]                                   # [T, r+rope]
    c = rms_norm(ckv[:, :r], p["kv_norm"]["g"], 1e-6)
    pos = torch.arange(x.shape[0], device=x.device)
    return c, rope(ckv[:, r:], pos, cfg["rope_theta"])


def attention(p: dict, cfg: dict, x: torch.Tensor, block: int
              ) -> torch.Tensor:
    t = x.shape[0]
    h = cfg["num_attention_heads"]
    nope, rdim = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    vdim = cfg["v_head_dim"]
    pos = torch.arange(t, device=x.device)
    q = (x @ p["w_q"]["w"]).view(t, h, nope + rdim)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], pos,
                                       cfg["rope_theta"])], dim=-1)
    c, k_rope = latent(p, cfg, x)
    k = torch.cat([(c @ p["w_uk"]["w"]).view(t, h, nope),
                   k_rope[:, None].expand(t, h, rdim)], dim=-1)
    v = (c @ p["w_uv"]["w"]).view(t, h, vdim)
    scale = (nope + rdim) ** -0.5
    out = torch.empty((t, h, vdim), dtype=x.dtype, device=x.device)
    for s in range(0, t, block):
        e = min(t, s + block)
        sc = torch.einsum("qhd,khd->hqk", q[s:e], k[:e]) * scale
        causal = pos[s:e, None] >= pos[None, :e]
        sc = sc.masked_fill(~causal, float("-inf"))
        out[s:e] = torch.einsum("hqk,khd->qhd", torch.softmax(sc, -1), v[:e])
    return out.reshape(t, h * vdim) @ p["wo"]["w"]


def gate(p: dict, cfg: dict, x: torch.Tensor, idx=None):
    """DeepSeek-V3's ``MoEGate`` with ``topk_method`` noaux_tc: (its own
    choice of experts [T, k], the experts taken -- ``idx`` where given,
    else its own --, their weights [T, k])."""
    t, k = x.shape[0], cfg["num_experts_per_tok"]
    n_group, e = cfg["n_group"], cfg["n_routed_experts"]
    scores = torch.sigmoid(x @ p["router"])
    choice = scores + p["score_bias"]
    groups = choice.view(t, n_group, -1).topk(min(2, e // n_group),
                                              dim=-1)[0].sum(-1)
    keep = torch.zeros_like(groups).scatter_(
        1, groups.topk(cfg["topk_group"], dim=-1)[1], 1.0)
    mask = keep[:, :, None].expand(t, n_group, e // n_group).reshape(t, e)
    own = choice.masked_fill(mask == 0, 0.0).topk(k, dim=-1)[1]
    idx = own if idx is None else idx
    w = scores.gather(1, idx)
    if k > 1 and cfg["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return own, idx, w * cfg["routed_scaling_factor"]


def moe(p: dict, cfg: dict, x: torch.Tensor, route=None):
    """(the MoE's output, whether each token's own choice of experts
    differs from the one taken [T] bool: ``route`` [T, k] where given, else
    its own)."""
    own, idx, w = gate(p, cfg, x, route)
    y = torch.zeros_like(x)
    for j in range(cfg["n_routed_experts"]):
        tok, slot = torch.nonzero(idx == j, as_tuple=True)
        if tok.numel():
            out = swiglu(x[tok], p["w_gate"][j], p["w_up"][j],
                         p["w_down"][j])
            y.index_add_(0, tok, out * w[tok, slot][:, None])
    s = p["shared"]
    differ = (own.sort(-1)[0] != idx.sort(-1)[0]).any(-1)
    return y + swiglu(x, s["w_gate"], s["w_up"], s["w_down"]), differ


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.to(torch.float32)


def _layer(params: dict, i: int) -> dict:
    """Layer ``i``'s weights in float32: the leading dense layers first,
    then the stacked ones."""
    dense = params.get("dense_layers", [])
    if i < len(dense):
        return _f32(dense[i])

    def pick(tree):
        if isinstance(tree, dict):
            return {k: pick(v) for k, v in tree.items()}
        return tree[i - len(dense)].to(torch.float32)
    return pick(params["layers"])


def embed(params: dict, cfg: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The token embedding: rows of the full table, or of the ROBE
    array."""
    if cfg.get("embedding") != "robe":
        return params["embed"]["table"][tokens].to(torch.float32)
    from reference.robe_hash import Robe
    robe = Robe(size=cfg["robe_size"], block=cfg["robe_block"],
                seed=cfg["robe_seed"])
    emb = robe.lookup(params["embed"]["memory"], tokens[:, None],
                      cfg["hidden_size"])
    return emb[:, 0].to(torch.float32)


def logits(params: dict, cfg: dict, tokens, at, device,
           block: int = 1024) -> torch.Tensor:
    """Logits [len(at), vocab] (float32, on ``device``) of the sequence
    ``tokens`` [T] at positions ``at``, with TF32 off."""
    return replay(params, cfg, tokens, at, None, device=device,
                  block=block)[0]


def replay(params: dict, cfg: dict, tokens, at, routes, device,
           block: int = 1024):
    """``logits``, with every MoE layer taking the experts ``routes``
    [MoE layers, T, k] give (None: its own choice): (the logits, at each
    position [T] the number of MoE layers whose own top-k would have
    chosen otherwise)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            tokens = torch.as_tensor(tokens, device=device).long()
            if routes is not None:
                routes = torch.as_tensor(routes, device=device).long()
            eps, n_dense = cfg["rms_norm_eps"], cfg["first_k_dense_replace"]
            differ = torch.zeros(len(tokens), dtype=torch.int64,
                                 device=device)
            x = embed(params, cfg, tokens)
            for i in range(cfg["num_hidden_layers"]):
                p = _layer(params, i)
                x = x + attention(p["attn"], cfg,
                                  rms_norm(x, p["attn_norm"]["g"], eps),
                                  block)
                hin = rms_norm(x, p["ffn_norm"]["g"], eps)
                if i < n_dense:
                    f = p["ffn"]
                    x = x + swiglu(hin, f["w_gate"], f["w_up"], f["w_down"])
                else:
                    y, d = moe(p["moe"], cfg, hin, None if routes is None
                               else routes[i - n_dense])
                    x, differ = x + y, differ + d
                del p
            at = torch.as_tensor(at, device=device).long()
            x = rms_norm(x[at], params["final_norm"]["g"].to(torch.float32),
                         eps)
            return x @ params["lm_head"].to(torch.float32), differ
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def first_latent(params: dict, cfg: dict, tokens, device) -> torch.Tensor:
    """The first layer's latent of every position of ``tokens`` [T]: the
    compressed kv and the rope key side by side [T, kv_lora_rank +
    qk_rope_head_dim], float32, TF32 off.  Its input is the token table
    alone, so a cache's own rounding shows here undiluted."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            tokens = torch.as_tensor(tokens, device=device).long()
            p = _layer(params, 0)
            c, k_rope = latent(p["attn"], cfg, rms_norm(
                embed(params, cfg, tokens), p["attn_norm"]["g"],
                cfg["rms_norm_eps"]))
            return torch.cat([c, k_rope], dim=-1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
