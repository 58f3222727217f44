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
item of one field; everything else is plain PyTorch.

Under an active ``repro_torch.dist`` context the entry points keep the
JAX package's global view (``dist.api`` contract point 1): the global
[B, T] batch in, the global logits and mean loss out, shards inside,
laid out as GSPMD lays out ``transformer_specs`` there, with the
collectives explicit (``dist.tp``):

* rows over the data axes; between blocks the activations cut along T
  over ``model`` when T divides it (sequence parallelism), all-gathered
  into each block and reduce-scattered out of its row-parallel output
  (all-reduced without the cut);
* attention head-parallel (``nn.attention``), the dense FFN column- then
  row-parallel, ``moe_dispatch="ep"`` the expert-parallel all_to_all
  dispatch (tokens over (data, model) with the cut, else over data; the
  aux loss averaged over those axes), the dense MoE dispatch over the
  rank's experts with the aux loss's statistics summed over the data axes;
* the ``full`` embedding a masked lookup of the rank's vocabulary rows
  reduced into the layout, ``robe`` the kernels' lookup of the rank's
  tokens on the whole array; ``lm_head`` vocabulary-parallel and
  ``cross_entropy`` too (all-reduced max, sum of exponentials and gold
  logit, the padded columns masked by global index);
* the decode caches cut along the sequence (``init_cache``), the prefill's
  keys and values handed back on the same cut (``fill_cache`` copies them
  into a longer cache).

Parameters are held as the rank's shards by the live spec tree
(``dist.placed``, which the train step sets from its ``specs=``), or
whole on every rank outside ``placed``; each layer takes the views its
computation needs (``Tp.view``: ``fsdp`` leaves all-gathered over the
data axes at use, whose transpose is a reduce-scatter).  Gradients are
those of the rank's own share of the loss; ``train.train_loop`` applies
the gradient rule.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tracing
from repro_torch.core.robe import RobeSpec, init_memory
from repro_torch.device import resolve_device
from repro_torch.dist import api as dist
from repro_torch.dist import collectives as coll
from repro_torch.dist.api import P, axes_tuple
from repro_torch.dist.tp import Tp
from repro_torch.kernels import ops
from repro_torch.nn.attention import (AttnConfig, _heads_tp, _q8,
                                      attention_apply, attention_init)
from repro_torch.nn.attention import init_cache as attn_init_cache
from repro_torch.nn.core import normal_init, rms_norm_apply, rms_norm_init
from repro_torch.nn.moe import (MoeConfig, _router, _shared_out,
                                moe_apply_dense, moe_apply_ep,
                                moe_apply_grouped, moe_init)
from repro_torch.tree import leaves, leaves_up_to, tree_map, unflatten


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
    moe_dispatch: str = "dense"      # "ep": grouped on one device
    capacity_factor: float = 1.25
    moe_scoring: str = "softmax"     # "sigmoid": DeepSeek-V3's noaux_tc
    routed_scale: float = 1.0
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
    norm_eps: float = 1e-6           # the block norms' and the final norm's

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
                         dispatch=self.moe_dispatch,
                         scoring=self.moe_scoring,
                         routed_scale=self.routed_scale)

    def robe_spec(self) -> RobeSpec:
        return RobeSpec(size=self.robe_size, block_size=self.robe_block,
                        seed=17)

    def param_count(self) -> int:
        """Total parameters (for 6·N·D model-flops accounting)."""
        d, f = self.d_model, self.d_ff
        if self.attn_kind == "mla":
            qd = self.qk_nope_dim + self.qk_rope_dim
            q = (d * self.q_lora_rank + self.q_lora_rank * self.n_heads * qd
                 if self.q_lora_rank else d * self.n_heads * qd)
            attn = (q + d * (self.kv_lora_rank + self.qk_rope_dim)
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


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _dense_ffn_init(generator, d: int, f: int, device) -> dict:
    return {"w_gate": normal_init(generator, (d, f), device, 0.02),
            "w_up": normal_init(generator, (d, f), device, 0.02),
            "w_down": normal_init(generator, (f, d), device, 0.02)}


def _dense_ffn_apply(p, x, tp=None, cut: bool = False):
    """The SwiGLU FFN.  With ``tp``: x in the layout between blocks and
    the output back in it; ``cut``: ``p`` holds the rank's columns of
    gate/up and rows of down (the output a partial sum)."""
    if tp is not None:
        x = tp.seq_in(x)
    h = torch.nn.functional.silu(x @ p["w_gate"].to(x.dtype)) \
        * (x @ p["w_up"].to(x.dtype))
    y = h @ p["w_down"].to(x.dtype)
    return y if tp is None else tp.seq_out(y, cut)


def _ffn_width(cfg: TransformerConfig) -> int:
    """The dense FFN's hidden width (a MoE config's dense layers')."""
    return cfg.d_ff_dense if (cfg.is_moe and cfg.d_ff_dense) else cfg.d_ff


def _layer_init(generator, cfg: TransformerConfig, moe: bool,
                device) -> dict:
    p = {"attn_norm": rms_norm_init(cfg.d_model, device),
         "ffn_norm": rms_norm_init(cfg.d_model, device),
         "attn": attention_init(generator, cfg.attn_cfg(), device)}
    if moe:
        p["moe"] = moe_init(generator, cfg.moe_cfg(), device)
    else:
        p["ffn"] = _dense_ffn_init(generator, cfg.d_model, _ffn_width(cfg),
                                   device)
    return p


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device) -> dict:
    """Random parameters in the JAX package's tree, drawn from
    ``generator`` in the order of its keys (embedding, the layers, the
    head), the scanned layers stacked along a leading L dim.  Each part is
    converted to ``param_dtype`` as it is drawn, and the stacked leaves
    are allocated once and filled layer by layer, so a bf16 config never
    holds an f32 copy of the tree."""
    def cast(tree):
        return tree_map(lambda x: x.to(cfg.param_dtype), tree)

    params: dict = {}
    if cfg.embedding == "robe":
        params["embed"] = cast({"memory": init_memory(
            generator, cfg.robe_spec(), device)})
    else:
        params["embed"] = cast({"table": normal_init(
            generator, (cfg.vocab_padded, cfg.d_model), device, 0.02)})
    if cfg.first_k_dense:
        params["dense_layers"] = [
            cast(_layer_init(generator, cfg, False, device))
            for _ in range(cfg.first_k_dense)]
    n = n_scanned(cfg)
    for i in range(n):
        layer = cast(_layer_init(generator, cfg, cfg.is_moe, device))
        if i == 0:
            params["layers"] = tree_map(
                lambda x: x.new_empty((n,) + tuple(x.shape)), layer)
        for dst, src in zip(leaves(params["layers"]), leaves(layer)):
            dst[i].copy_(src)
        del layer
    params["final_norm"] = cast(rms_norm_init(cfg.d_model, device))
    params["lm_head"] = normal_init(generator, (cfg.d_model,
                                                cfg.vocab_padded), device,
                                    0.02).to(cfg.param_dtype)
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
# the layout on a mesh: each leaf's compute view
# ---------------------------------------------------------------------------

_COL = {"wq", "w_q", "w_uq", "w_uk", "w_uv"}


def _want(path: tuple, ndim: int, cfg: TransformerConfig, tp: Tp):
    """The block of a leaf the computation takes (None: whole): ``path``
    its keys within a layer, or from the top for the embedding and the
    head.  Heads, hidden widths, experts and the vocabulary are cut over
    the model axes where they divide them."""
    ax = tp.axes
    last, first = P(*((None,) * (ndim - 1) + (ax,))), P(ax)
    name = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    if path[0] == "attn":
        heads, kv = _heads_tp(cfg.attn_cfg(), tp)
        if parent in ("wk", "wv"):
            return last if kv else None
        if parent in _COL:
            return last if heads else None
        if parent == "wo" and name == "w":
            return first if heads else None
        return None
    if path[0] == "ffn":
        if not tp.splits(_ffn_width(cfg)):
            return None
        return last if name in ("w_gate", "w_up") else first
    if path[0] == "moe":
        if name in ("w_gate", "w_up", "w_down") and "shared" not in path \
                and tp.splits(cfg.n_experts):
            return first
        return None
    if path == ("embed", "table"):
        return first if tp.splits(cfg.vocab_padded) else None
    if path == ("lm_head",):
        return last if tp.splits(cfg.vocab_padded) else None
    return None


def _views(tree, specs, tp: Tp, cfg: TransformerConfig, path=()):
    """``tree``'s leaves as the computation takes them (``Tp.view``) from
    the shards ``specs`` names (None: whole)."""
    if isinstance(tree, dict):
        return {k: _views(v, None if specs is None else specs[k], tp, cfg,
                          path + (k,)) for k, v in tree.items()}
    return tp.view(tree, specs, _want(path, tree.dim(), cfg, tp))


def _stacked(params: dict, specs, tp: Tp):
    """The scanned layers' leaves and one layer's specs (the stack's
    leading entry dropped); a leaf cut along L itself is gathered first."""
    stacked = params["layers"]
    if specs is None:
        return stacked, None
    ws, ss = [], []
    for w, s in zip(leaves(stacked), leaves_up_to(stacked, specs["layers"])):
        if s is not None and len(s) and s[0] is not None:
            w = coll.all_gather(w, tp.ctx, axes_tuple(s[0]), dim=0)
        ws.append(w)
        ss.append(None if s is None else P(*tuple(s)[1:]))
    return unflatten(stacked, ws), unflatten(stacked, ss)


def _plan(t: int) -> Optional[Tp]:
    ctx = dist.current()
    return None if ctx is None else Tp.of(ctx, t)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _embed(params, cfg: TransformerConfig, tokens: torch.Tensor,
           tp: Optional[Tp] = None, specs=None) -> torch.Tensor:
    """tokens [b, T] (the rank's rows) -> [b, T, d], or with ``tp`` the
    layout between blocks."""
    if tp is not None:
        params = {"embed": _views(params["embed"], None if specs is None
                                  else specs["embed"], tp, cfg, ("embed",))}
    if cfg.embedding == "robe":
        if tp is not None and tp.sp:
            tokens = tp.block(tokens, 1)       # the rank's tokens
        # every token one item of one field (table 0): the backward's
        # buckets stay one field wide
        b, t = tokens.shape
        rows = tokens.reshape(b * t, 1).to(torch.int32).contiguous()
        x = ops.robe_lookup(params["embed"]["memory"], rows, (0,),
                            cfg.d_model, cfg.robe_spec())
        return x.reshape(b, t, cfg.d_model).to(cfg.compute_dtype)
    table = params["embed"]["table"]
    if tp is None or not tp.splits(cfg.vocab_padded):
        x = table[tokens.long()].to(cfg.compute_dtype)
        return x if tp is None else tp.seq_out(x, False)
    # the rank's vocabulary rows: a masked lookup, reduced into the layout
    rows = table.shape[0]
    local = tokens.long() - tp.index * rows
    hit = (local >= 0) & (local < rows)
    part = table[local.clamp(0, rows - 1)].to(cfg.compute_dtype)
    part = torch.where(hit[..., None], part,
                       torch.zeros((), dtype=part.dtype, device=part.device))
    return tp.seq_out(part, True)


def _moe_block(p, cfg: TransformerConfig, x: torch.Tensor,
               tp: Optional[Tp] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,T,d] -> (y, aux); with ``tp``, x and y in the layout between
    blocks and ``p`` the rank's views."""
    b, t, d = x.shape
    mcfg = cfg.moe_cfg()
    if tp is None:
        apply = moe_apply_grouped if mcfg.dispatch == "ep" else \
            moe_apply_dense
        with tracing.span("lm.moe") as sp:
            sp.add("slots", b * t * mcfg.top_k)
            y, aux = apply(p, mcfg, x.reshape(b * t, d))
        return y.reshape(b, t, d), aux
    if mcfg.dispatch == "ep":
        # the rank's tokens: over (data, model) with the sequence cut, else
        # over data (every model rank dispatches the same ones)
        aux_axes = tp.dp + (tp.axes if tp.sp else ())
        y, aux = moe_apply_ep(p, mcfg, x.reshape(b * t, d), tp.ctx,
                              tp.axes, aux_axes)
        return y.reshape(b, t, d), aux
    # dense dispatch: every token through the rank's experts, the partial
    # combine reduced into the layout; the shared experts on the rank's
    # own tokens, after the reduction
    xa = tp.seq_in(x)
    n = xa.shape[0] * xa.shape[1]
    flat = xa.reshape(n, d)
    gates, idx, aux = _router(p, mcfg, flat, tp.ctx, tp.dp)
    h = torch.einsum("nd,edf->enf", flat, p["w_gate"].to(x.dtype))
    u = torch.einsum("nd,edf->enf", flat, p["w_up"].to(x.dtype))
    y_e = torch.einsum("enf,efd->end", torch.nn.functional.silu(h) * u,
                       p["w_down"].to(x.dtype))
    combine = torch.zeros((n, mcfg.n_experts), dtype=x.dtype,
                          device=x.device).scatter_add(1, idx, gates)
    cut = tp.splits(mcfg.n_experts)
    if cut:
        combine = tp.block(combine, 1)
    y = torch.einsum("ne,end->nd", combine, y_e).reshape(xa.shape)
    return tp.seq_out(y, cut) + _shared_out(p, x), aux


def _layer_apply(p, cfg: TransformerConfig, moe: bool, x, positions,
                 collect_kv: bool = False, tp: Optional[Tp] = None,
                 cache=None, kv_len=None):
    """One block: (x, aux, the prefill's kv or the decode cache).  With
    ``tp`` x is in the layout between blocks and ``p`` the rank's
    views."""
    with tracing.span("lm.attn"):
        h = rms_norm_apply(p["attn_norm"], x, cfg.norm_eps)
        if tp is not None:
            h = tp.seq_in(h)
        h, kv = attention_apply(p["attn"], cfg.attn_cfg(), h, positions,
                                cache=cache, kv_len=kv_len,
                                return_kv=collect_kv, tp=tp)
        if tp is not None:
            h = tp.seq_out(h, _heads_tp(cfg.attn_cfg(), tp)[0])
        x = x + h
    with tracing.span("lm.ffn"):
        hin = rms_norm_apply(p["ffn_norm"], x, cfg.norm_eps)
        if moe:
            h, aux = _moe_block(p["moe"], cfg, hin, tp)
        else:
            h = _dense_ffn_apply(p["ffn"], hin, tp, tp is not None and
                                 tp.splits(_ffn_width(cfg)))
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + h, aux, kv


def _stack_kv(kvs: list):
    if not kvs or kvs[0] is None:
        return None
    return {k: torch.stack([kv[k] for kv in kvs]) for k in kvs[0]}


def _shard_kv(kv, tp: Optional[Tp]):
    """A prefill's keys and values [b, T, ...] on the decode caches' cut:
    the rank's block of the sequence when T divides the model axes."""
    if kv is None or tp is None or not tp.sp:
        return kv
    return {k: tp.block(v, 1) for k, v in kv.items()}


def _trunk(params, cfg: TransformerConfig, tokens: torch.Tensor,
           collect_cache: bool, tp: Optional[Tp]):
    """The embedding and the layers of the rank's rows of ``tokens``: (x
    after the final norm -- with ``tp`` in the layout between blocks --,
    the aux loss, the prefill's kv or None)."""
    specs = None if tp is None else dist.live_specs()
    if tp is not None:
        tokens = tp.rows(tokens)
    with tracing.span("lm.embed"):
        x = _embed(params, cfg, tokens, tp, specs)
    positions = torch.arange(tokens.shape[1], device=x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    dense_kv = []
    for i, p in enumerate(params.get("dense_layers", [])):
        if tp is not None:
            p = _views(p, None if specs is None else
                       specs["dense_layers"][i], tp, cfg)
        x, aux, kv = _layer_apply(p, cfg, False, x, positions,
                                  collect_cache, tp)
        aux_total = aux_total + aux
        dense_kv.append(_shard_kv(kv, tp))

    stacked, lspec = (params["layers"], None) if tp is None else \
        _stacked(params, specs, tp)

    def body(layer_p, xx):
        if tp is not None:
            layer_p = _views(layer_p, lspec, tp, cfg)
        return _layer_apply(layer_p, cfg, cfg.is_moe, xx, positions,
                            collect_cache, tp)

    remat = cfg.remat and torch.is_grad_enabled()
    kvs = []
    for layer_p in layer_params({"layers": stacked}):
        if remat:
            x, aux, kv = checkpoint(body, layer_p, x, use_reentrant=False)
        else:
            x, aux, kv = body(layer_p, x)
        aux_total = aux_total + aux
        kvs.append(_shard_kv(kv, tp))
    x = rms_norm_apply(params["final_norm"], x, cfg.norm_eps)
    cache = None
    if collect_cache:
        cache = {"layers": _stack_kv(kvs)}
        if dense_kv:
            cache["dense_layers"] = dense_kv
    return x, aux_total, cache


def _head(params, cfg: TransformerConfig, x: torch.Tensor, last: bool,
          tp: Optional[Tp]) -> torch.Tensor:
    """The logits of x (the last position's with ``last``); with ``tp``
    the rank's vocabulary columns of its rows."""
    with tracing.span("lm.head"):
        w = params["lm_head"]
        if tp is not None:
            specs = dist.live_specs()
            w = tp.view(w, None if specs is None else specs["lm_head"],
                        _want(("lm_head",), w.dim(), cfg, tp))
            x = tp.seq_in(x)
        if last:
            x = x[:, -1]
        return x @ w.to(x.dtype)


def _gather_logits(logits: torch.Tensor, cfg: TransformerConfig,
                   tp: Optional[Tp], n: int) -> torch.Tensor:
    """The global logits from every rank's vocabulary columns of its
    rows."""
    if tp is None:
        return logits
    if tp.splits(cfg.vocab_padded):
        logits = tp.gather(logits, logits.dim() - 1)
    return tp.gather_rows(logits, n)


def forward(params, cfg: TransformerConfig, tokens: torch.Tensor,
            collect_cache: bool = False, logits_mode: str = "all"):
    """tokens [B,T] -> (logits, aux[, cache]).

    logits_mode: "all" ([B,T,V], training) | "last" ([B,V], prefill
    serving).  ``collect_cache``: also the prefill's keys and values,
    {"layers": stacked [L, B, T, ...], "dense_layers": [...]} (under a
    mesh the rank's rows and, when T divides the model axes, its block of
    the sequence: the decode caches' cut)."""
    tp = _plan(tokens.shape[1])
    b, t = tokens.shape
    with tracing.span("lm.prefill") as sp:
        sp.add("samples", b)
        sp.add("tokens", b * t)
        sp.add("cache_len", t)
        x, aux_total, cache = _trunk(params, cfg, tokens, collect_cache, tp)
        logits = _gather_logits(_head(params, cfg, x, logits_mode == "last",
                                      tp), cfg, tp, b)
    if collect_cache:
        return logits, aux_total, cache
    return logits, aux_total


def cross_entropy(cfg: TransformerConfig, logits: torch.Tensor,
                  labels: torch.Tensor, tp: Optional[Tp] = None
                  ) -> torch.Tensor:
    """Mean next-token cross entropy of ``logits`` [..., V].  The logits
    stay in the compute dtype (the padded vocabulary masked to -1e30);
    only the max-shifted exp and sum run in f32.  With ``tp`` and a
    vocabulary cut over the model axes, ``logits`` are the rank's columns
    and the max (no gradient), the sum of exponentials and the gold logit
    are all-reduced over them."""
    cut = tp is not None and tp.splits(cfg.vocab_padded)
    lg = logits
    col0 = tp.index * lg.shape[-1] if cut else 0
    if cfg.vocab_padded != cfg.vocab:
        real = torch.arange(col0, col0 + lg.shape[-1],
                            device=lg.device) < cfg.vocab
        lg = torch.where(real, lg, torch.tensor(-1e30, dtype=lg.dtype,
                                                device=lg.device))
    m = lg.detach().amax(dim=-1, keepdim=True).to(torch.float32)
    if cut:
        m = coll.all_reduce_(m.contiguous(), tp.ctx, tp.axes, "max")
    ex = torch.exp(lg.to(torch.float32) - m)
    se = torch.sum(ex, dim=-1)
    local = labels.long() - col0
    gold = torch.gather(lg, -1, local.clamp(0, lg.shape[-1] - 1)[..., None]
                        )[..., 0].to(torch.float32)
    if cut:
        hit = (local >= 0) & (local < lg.shape[-1])
        gold = torch.where(hit, gold, torch.zeros((), dtype=gold.dtype,
                                                  device=gold.device))
        se = coll.all_reduce(se, tp.ctx, tp.axes)
        gold = coll.all_reduce(gold, tp.ctx, tp.axes)
    lse = torch.log(se) + m[..., 0]
    return (lse - gold).mean()


def loss_fn(params, cfg: TransformerConfig, batch: dict
            ) -> Tuple[torch.Tensor, dict]:
    """``cross_entropy`` of the forward's logits + 0.001 · the MoE aux
    loss.  Under a mesh the value is the global mean; the gradient is
    that of the rank's own share (the mean over its rows, the same on
    every model rank)."""
    tokens = batch["tokens"]
    tp = _plan(tokens.shape[1])
    x, aux, _ = _trunk(params, cfg, tokens, False, tp)
    logits = _head(params, cfg, x, False, tp)
    if tp is None:
        ce = cross_entropy(cfg, logits, batch["labels"])
    else:
        ce = tp.mean(cross_entropy(cfg, logits, tp.rows(batch["labels"]),
                                   tp), tokens.shape[0])
    return ce + 0.001 * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Zeroed decode caches in ``cfg.cache_dtype``: the scanned layers'
    stacked [L, B, max_len, ...], the dense layers' a list, on ``device``
    (default ``cuda``: raises without a card; under a mesh, the mesh's).
    Under a mesh the rank's shard: its rows of the batch and its block of
    ``max_len / M`` positions (``seq_kv_model``)."""
    ctx = dist.current()
    if ctx is None:
        device = resolve_device(device)
    else:
        device = ctx.device if device is None else torch.device(device)
        tp = Tp.of(ctx, 1)
        if max_len % tp.size:
            raise ValueError(f"init_cache: {max_len} slots do not cut over "
                             f"the model axes' {tp.size} ranks")
        batch, max_len = tp.n_rows(batch), max_len // tp.size

    def one(lead=()):
        c = attn_init_cache(cfg.attn_cfg(), 1, 1, cfg.cache_dtype, "meta")
        return {k: torch.zeros(lead + (batch, max_len) + tuple(v.shape[2:]),
                               dtype=v.dtype, device=device)
                for k, v in c.items()}

    caches = {"layers": one((n_scanned(cfg),))}
    if cfg.first_k_dense:
        caches["dense_layers"] = [one() for _ in range(cfg.first_k_dense)]
    return caches


def fill_cache(cfg: TransformerConfig, caches: dict, pre: dict,
               t: int) -> dict:
    """Write a prefill's keys and values (``forward(...,
    collect_cache=True)`` of ``t`` tokens: positions 0..t-1) into decode
    caches from ``init_cache``, in place; an int8 cache takes them
    quantized as a decode step writes them.  Under a mesh both are the
    rank's shards: the prefill's sequence blocks are gathered over the
    model axes and each rank keeps the positions of its cache block."""
    tp = _plan(t)

    def one(cache: dict, kv: dict, seq: int) -> None:
        kv = dict(kv)
        if tp is not None and tp.sp:
            with torch.no_grad():
                kv = {k: tp.gather(v, seq) for k, v in kv.items()}
        if "k_scale" in cache:
            kv["k"], kv["k_scale"] = _q8(kv["k"].to(torch.float32))
            kv["v"], kv["v_scale"] = _q8(kv["v"].to(torch.float32))
        for k, buf in cache.items():
            s = buf.shape[seq]
            off = 0 if tp is None else tp.index * s
            n = min(t, off + s) - off
            if n > 0:
                buf.narrow(seq, 0, n).copy_(kv[k].narrow(seq, off, n))

    one(caches["layers"], pre["layers"], 2)
    for c, kv in zip(caches.get("dense_layers", []),
                     pre.get("dense_layers", [])):
        one(c, kv, 1)
    return caches


def decode_step(params, cfg: TransformerConfig, caches, tokens: torch.Tensor,
                pos) -> Tuple[torch.Tensor, Any]:
    """One decode step: tokens [B,1] at position ``pos`` with a cache filled
    up to ``pos``.  Writes the step's keys and values into ``caches`` at
    ``pos`` (in place) and returns (logits [B,V], caches).  Under a mesh
    the caches are the rank's shards (``init_cache``) and the logits
    global."""
    pos = int(pos)
    n = tokens.shape[0]
    with tracing.span("lm.decode") as sp:
        sp.add("samples", n)
        sp.add("tokens", tokens.numel())
        sp.add("cache_len", pos + 1)
        return _decode(params, cfg, caches, tokens, pos, n)


def _decode(params, cfg: TransformerConfig, caches, tokens: torch.Tensor,
            pos: int, n: int) -> Tuple[torch.Tensor, Any]:
    tp = _plan(tokens.shape[1])
    specs = None if tp is None else dist.live_specs()
    if tp is not None:
        tokens = tp.rows(tokens)
    with tracing.span("lm.embed"):
        x = _embed(params, cfg, tokens, tp, specs)
    kv_len = torch.full((tokens.shape[0],), pos + 1, dtype=torch.int32,
                        device=x.device)
    # from Python data: the attention reads the position back as an int,
    # which a fake tensor (the dry run's) answers only for such a tensor
    positions = torch.tensor([pos] * tokens.shape[1], dtype=torch.int32,
                             device=x.device)
    for i, (p, c) in enumerate(zip(params.get("dense_layers", []),
                                   caches.get("dense_layers", []))):
        if tp is not None:
            p = _views(p, None if specs is None else
                       specs["dense_layers"][i], tp, cfg)
        x, _, _ = _layer_apply(p, cfg, False, x, positions, tp=tp, cache=c,
                               kv_len=kv_len)
    stacked, lspec = (params["layers"], None) if tp is None else \
        _stacked(params, specs, tp)
    for i, layer_p in enumerate(layer_params({"layers": stacked})):
        if tp is not None:
            layer_p = _views(layer_p, lspec, tp, cfg)
        layer_c = {k: v[i] for k, v in caches["layers"].items()}
        x, _, _ = _layer_apply(layer_p, cfg, cfg.is_moe, x, positions, tp=tp,
                               cache=layer_c, kv_len=kv_len)
    x = rms_norm_apply(params["final_norm"], x, cfg.norm_eps)
    logits = _gather_logits(_head(params, cfg, x, True, tp), cfg, tp, n)
    return logits, caches
