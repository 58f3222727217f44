"""The port's ``moonlight-16b-a3b`` bundle against its plain reference
(``bench/reference/moonlight.py``, the one the benchmark's output check
uses), on the CPU at smoke size, float32, on seeded random weights:

* ``forward``'s logits, and prefill then eight ``decode_step``s, each
  step's logits against the reference's full forward at that position;
* the sigmoid ``noaux_tc`` router: the correction bias changes which
  experts are chosen but not how they are weighted;
* the dropless grouped dispatch against the dense one, also when one
  expert takes every token, and on another bundle's ``"ep"`` config;
* MLA without a q down-projection, the block norms' eps, and the full
  config's sizes (parameters and cache bytes a token);
* ``init_params`` in bf16 equals the f32 draws rounded, leaf for leaf;
* the reference's ROBE token table is the port's, and its first layer's
  latent what the port's cache holds;
* ``nn.moe.route_log`` records each router call's experts, and the
  reference replaying them gives its own logits, counting no difference;
  a moved choice is counted at its position.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.models import transformer as T
from repro_torch.nn import moe as tmoe
from repro_torch.tree import leaves, tree_map

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "bench")
ARCH = "moonlight-16b-a3b"
TOL = dict(rtol=1e-5, atol=1e-5)


def _load_reference():
    """``bench/reference/moonlight.py``, loaded by its path (a ROBE table
    also needs the benchmark's ``reference/robe_hash.py`` on the path)."""
    spec = importlib.util.spec_from_file_location(
        "bench_reference_moonlight", os.path.join(BENCH, "reference",
                                                  "moonlight.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load_reference()


def hf_config(cfg: T.TransformerConfig) -> dict:
    """The reference's configuration (``config.json``'s keys) of a port
    config."""
    return {"hidden_size": cfg.d_model, "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads,
            "kv_lora_rank": cfg.kv_lora_rank,
            "qk_nope_head_dim": cfg.qk_nope_dim,
            "qk_rope_head_dim": cfg.qk_rope_dim,
            "v_head_dim": cfg.v_head_dim, "q_lora_rank": None,
            "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
            "first_k_dense_replace": cfg.first_k_dense,
            "n_routed_experts": cfg.n_experts,
            "num_experts_per_tok": cfg.top_k, "n_group": 1, "topk_group": 1,
            "norm_topk_prob": True,
            "routed_scaling_factor": cfg.routed_scale,
            "vocab_size": cfg.vocab, "robe_size": cfg.robe_size,
            "robe_block": cfg.robe_block, "robe_seed": 17}


def _smoke(**over):
    return get_arch(ARCH).make_config("smoke", **over)


def _params(cfg, seed: int = 0):
    return T.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")


def _tokens(cfg, b: int, t: int, seed: int = 1) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (b, t), generator=g)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_smoke_config_keeps_the_mechanisms():
    cfg = _smoke()
    assert cfg.attn_kind == "mla" and cfg.q_lora_rank == 0
    assert cfg.moe_scoring == "sigmoid" and cfg.routed_scale == 2.446
    assert cfg.norm_eps == 1e-5
    assert cfg.moe_dispatch == "ep" and cfg.first_k_dense == 1
    assert cfg.n_layers - cfg.first_k_dense == 2 and cfg.n_experts == 8
    p = _params(cfg)
    attn = p["layers"]["attn"]
    assert "w_q" in attn and "w_dq" not in attn and "q_norm" not in attn
    assert p["layers"]["moe"]["score_bias"].shape == (2, 8)
    assert "score_bias" not in _params(
        get_arch("qwen3-moe-30b-a3b").make_config("smoke"))["layers"]["moe"]


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_reference(seed):
    cfg = _smoke()
    p = _params(cfg, seed)
    tokens = _tokens(cfg, 2, 24, seed + 10)
    with torch.no_grad():
        logits, _ = T.forward(p, cfg, tokens)
    hf = hf_config(cfg)
    for b in range(tokens.shape[0]):
        want = ref.logits(p, hf, tokens[b], range(24), "cpu", block=7)
        torch.testing.assert_close(logits[b], want, **TOL)


def test_prefill_then_decode_matches_reference():
    cfg = _smoke()
    p = _params(cfg, 3)
    t0, steps, b = 16, 8, 2
    seq = _tokens(cfg, b, t0 + steps, 4)
    caches = T.init_cache(cfg, b, t0 + steps, device="cpu")
    hf = hf_config(cfg)
    with torch.no_grad():
        last, _, pre = T.forward(p, cfg, seq[:, :t0], collect_cache=True,
                                 logits_mode="last")
        T.fill_cache(cfg, caches, pre, t0)
        want = [ref.logits(p, hf, seq[r], range(t0 - 1, t0 + steps), "cpu")
                for r in range(b)]
        torch.testing.assert_close(last, torch.stack([w[0] for w in want]),
                                   **TOL)
        for j in range(steps):
            got, caches = T.decode_step(p, cfg, caches,
                                        seq[:, t0 + j:t0 + j + 1], t0 + j)
            torch.testing.assert_close(
                got, torch.stack([w[j + 1] for w in want]), **TOL)


def _router_case():
    cfg = _smoke().moe_cfg()
    p = tmoe.moe_init(torch.Generator().manual_seed(5), cfg, "cpu")
    x = torch.randn(64, cfg.d_model, generator=torch.Generator()
                    .manual_seed(6))
    return cfg, p, x


def test_router_bias_chooses_but_does_not_weight():
    cfg, p, x = _router_case()
    scores = torch.sigmoid(x @ p["router"])
    for bias in (torch.zeros(cfg.n_experts), p["score_bias"],
                 torch.linspace(-0.3, 0.3, cfg.n_experts)):
        q = dict(p, score_bias=bias)
        gates, idx, _ = tmoe._router(q, cfg, x)
        assert torch.equal(idx, tmoe.top_k(scores + bias, cfg.top_k)[1])
        chosen = scores.gather(1, idx)
        torch.testing.assert_close(
            gates, chosen / chosen.sum(-1, keepdim=True) * 2.446, **TOL)
    base = tmoe._router(dict(p, score_bias=torch.zeros(cfg.n_experts)),
                        cfg, x)[1]
    # a bias on one expert alone moves the choice toward it, and the gates
    # of the tokens it joins are still their sigmoid scores normalised
    lift = torch.zeros(cfg.n_experts)
    lift[3] = 1.0
    gates, idx, _ = tmoe._router(dict(p, score_bias=lift), cfg, x)
    assert not torch.equal(idx, base)
    assert bool((idx == 3).any(-1).all())
    assert not bool((base == 3).any(-1).all())
    chosen = scores.gather(1, idx)
    torch.testing.assert_close(
        gates, chosen / chosen.sum(-1, keepdim=True) * 2.446, **TOL)


@pytest.mark.parametrize("scoring", ["sigmoid", "softmax"])
@pytest.mark.parametrize("skew", [False, True])
def test_grouped_dispatch_matches_dense(scoring, skew):
    cfg, p, x = _router_case()
    cfg = dataclasses.replace(cfg, scoring=scoring)
    if skew:
        # expert 5 first for every token: it takes all of them
        if scoring == "sigmoid":
            p = dict(p, score_bias=torch.zeros(cfg.n_experts)
                     .index_fill_(0, torch.tensor([5]), 10.0))
        else:
            router = p["router"].clone()
            router[:, 5] = 0.0
            router[0, 5] = 50.0
            p = dict(p, router=router)
            x = x.clone()
            x[:, 0] = 1.0
    g, idx, _ = tmoe._router(p, cfg, x)
    if skew:
        assert bool((idx[:, 0] == 5).all())
    y_d, aux_d = tmoe.moe_apply_dense(p, cfg, x)
    y_g, aux_g = tmoe.moe_apply_grouped(p, cfg, x)
    torch.testing.assert_close(y_g, y_d, **TOL)
    assert torch.equal(aux_g, aux_d)


def test_grouped_dispatch_gradients_match_dense():
    cfg, p, x = _router_case()
    ws = {k: p[k].clone().requires_grad_() for k in ("w_gate", "w_up",
                                                      "w_down")}
    grads = []
    for fn in (tmoe.moe_apply_dense, tmoe.moe_apply_grouped):
        y, _ = fn(dict(p, **ws), cfg, x)
        grads.append(torch.autograd.grad((y ** 2).sum(), list(ws.values())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, **TOL)


def test_ep_config_on_one_device_is_the_dense_dispatch():
    """Another bundle's ``"ep"`` config now takes the grouped dispatch on
    one device: its logits are the dense dispatch's."""
    ep = get_arch("qwen3-moe-30b-a3b").make_config("smoke",
                                                   moe_dispatch="ep")
    dense = dataclasses.replace(ep, moe_dispatch="dense")
    p = _params(ep, 7)
    tokens = _tokens(ep, 2, 16, 8)
    with torch.no_grad():
        torch.testing.assert_close(T.forward(p, ep, tokens)[0],
                                   T.forward(p, dense, tokens)[0], **TOL)


def test_norm_eps_reaches_the_block_and_final_norms():
    cfg = _smoke()
    p = _params(cfg, 9)
    tokens = _tokens(cfg, 1, 8, 9)
    with torch.no_grad():
        a = T.forward(p, cfg, tokens)[0]
        b = T.forward(p, dataclasses.replace(cfg, norm_eps=1e-6), tokens)[0]
        c = T.forward(p, dataclasses.replace(cfg, norm_eps=1.0), tokens)[0]
    assert not torch.equal(a, b)
    assert (a - c).abs().max() > 100 * (a - b).abs().max()


def test_mla_without_q_lora_counts_its_params():
    cfg = _smoke()
    p = _params(cfg)
    norms = sum(x.numel() for path, x in _named(p) if path[-1] in ("g",)
                or path[-1] == "score_bias")
    assert sum(x.numel() for x in leaves(p)) - norms == cfg.param_count()


def _named(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named(v, path + (i,))
    else:
        yield path, tree


def test_full_config_sizes():
    """15.96 B parameters, 15.67 B with the 8× ROBE token table (41.9 M
    slots), and 31,104 latent-cache bytes a token (27 × 576 × 2)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    full = get_arch(ARCH).make_config("full")
    robe = get_arch(ARCH).make_config("full", embedding="robe")
    assert full.param_count() == 15_959_982_080
    assert robe.robe_size == 41_943_040
    with FakeTensorMode():
        n_full = sum(x.numel() for x in leaves(
            T.init_params(full, torch.Generator(), "cpu")))
        n_robe = sum(x.numel() for x in leaves(
            T.init_params(robe, torch.Generator(), "cpu")))
        cache = T.init_cache(full, 1, 1, device="cpu")
    assert round(n_full / 1e9, 2) == 15.96 and round(n_robe / 1e9, 2) == 15.67
    assert n_full - n_robe == 163_840 * 2_048 - 41_943_040
    assert sum(x.numel() * x.element_size() for x in leaves(cache)) == 31_104


def test_init_params_in_bf16_rounds_the_same_draws():
    f32 = _smoke()
    bf = dataclasses.replace(f32, param_dtype=torch.bfloat16)
    a = tree_map(lambda x: x.to(torch.bfloat16), _params(f32, 11))
    b = _params(bf, 11)
    for x, y in zip(leaves(a), leaves(b)):
        assert y.dtype == torch.bfloat16 and torch.equal(x, y)


def test_reference_robe_table_matches_the_port(monkeypatch):
    monkeypatch.syspath_prepend(BENCH)
    cfg = _smoke(embedding="robe")
    p = _params(cfg, 14)
    tokens = _tokens(cfg, 2, 12, 15)
    with torch.no_grad():
        logits, _ = T.forward(p, cfg, tokens)
    hf = dict(hf_config(cfg), embedding="robe")
    for b in range(2):
        torch.testing.assert_close(
            logits[b], ref.logits(p, hf, tokens[b], range(12),
                                  device="cpu"), **TOL)


def test_reference_first_latent_is_the_ports_cache():
    """What the first layer's cache holds after a prefill and decode steps
    is the reference's latent of those positions."""
    cfg = _smoke()
    p = _params(cfg, 20)
    t0, steps, b = 10, 4, 2
    seq = _tokens(cfg, b, t0 + steps, 21)
    caches = T.init_cache(cfg, b, t0 + steps, device="cpu")
    with torch.no_grad():
        pre = T.forward(p, cfg, seq[:, :t0], collect_cache=True,
                        logits_mode="last")[2]
        T.fill_cache(cfg, caches, pre, t0)
        for j in range(steps):
            caches = T.decode_step(p, cfg, caches,
                                   seq[:, t0 + j:t0 + j + 1], t0 + j)[1]
    c = caches["dense_layers"][0]
    got = torch.cat([c["c_kv"], c["k_rope"]], dim=-1)
    for r in range(b):
        torch.testing.assert_close(
            got[r], ref.first_latent(p, hf_config(cfg), seq[r], "cpu"), **TOL)


def test_route_log_records_each_router_call():
    cfg = _smoke()
    p = _params(cfg, 16)
    tokens = _tokens(cfg, 2, 12, 17)
    with torch.no_grad():
        T.forward(p, cfg, tokens)                      # no log open
        with tmoe.route_log() as log:
            T.forward(p, cfg, tokens)
        T.forward(p, cfg, tokens)
    n_moe = cfg.n_layers - cfg.first_k_dense
    assert len(log.idx) == n_moe
    assert all(i.shape == (24, cfg.top_k) for i in log.idx)
    mcfg, mp, x = _router_case()
    with tmoe.route_log() as outer:
        with tmoe.route_log() as inner:
            idx = tmoe._router(mp, mcfg, x)[1]
        assert not outer.idx and torch.equal(inner.idx[0], idx)


def test_reference_replays_the_ports_routes():
    cfg = _smoke()
    p = _params(cfg, 18)
    seq = _tokens(cfg, 1, 20, 19)
    hf = hf_config(cfg)
    with torch.no_grad(), tmoe.route_log() as log:
        T.forward(p, cfg, seq)
    routes = torch.stack(log.idx)                      # [MoE layers, T, k]
    own = ref.logits(p, hf, seq[0], range(20), "cpu")
    got, differ = ref.replay(p, hf, seq[0], range(20), routes, "cpu")
    assert differ.shape == (20,) and not differ.any()
    assert torch.equal(got, own)
    moved = routes.clone()
    moved[0, 3] = torch.arange(cfg.top_k) + 7 - cfg.top_k + 1
    got, differ = ref.replay(p, hf, seq[0], range(20), moved, "cpu")
    assert differ.tolist() == [0] * 3 + [1] + [0] * 16
    assert not torch.allclose(got[3:], own[3:], **TOL)
    torch.testing.assert_close(got[:3], own[:3], **TOL)


def test_reference_counts_each_layer_that_differs():
    """A position whose choice moved in every MoE layer counts each."""
    cfg = _smoke()
    p = _params(cfg, 22)
    seq = _tokens(cfg, 1, 12, 23)
    with torch.no_grad(), tmoe.route_log() as log:
        T.forward(p, cfg, seq)
    moved = torch.stack(log.idx).clone()
    other = torch.arange(cfg.n_experts)
    for layer in range(moved.shape[0]):
        free = other[~torch.isin(other, moved[layer, 5])]
        moved[layer, 5] = free[:cfg.top_k]
    differ = ref.replay(p, hf_config(cfg), seq[0], range(12), moved,
                        "cpu")[1]
    assert differ[5] == moved.shape[0] and differ.sum() == moved.shape[0]
