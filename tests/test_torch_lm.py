"""The port's LM family against the JAX package, on the CPU.

The five registered bundles' smoke configs on ``full`` and ``robe``:
logits, the MoE aux loss, ``loss_fn``'s loss and every gradient leaf
within rtol = atol = 1e-5 in f32, with params from ``repro``'s init;
``decode_step`` chains step for step; the MoE router and its tie rule;
``remat`` and ``scan_layers``; the full configs' sizes and fields;
``LmStream``; and ``examples/lm_robe_embedding.py``'s two 120-step runs,
each port step taken from the JAX run's state before it.  On the CPU the
port runs its plain versions, so every kernel's ``launches`` count stays
0.  Under a one-rank mesh the entry points run the sharded LM and match
the run without one (``tests/test_torch_dist_lm_ranks.py`` holds four
ranks to the JAX package).
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.data.lm_data import LmDataConfig as JLmDataConfig
from repro.data.lm_data import LmStream as JLmStream
from repro.models import transformer as jtr
from repro.nn import moe as jmoe
from repro.train import optimizer as jopt
from repro.train import train_loop as jtl
from repro_torch import kernels as tk
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs.registry import LM_SHAPES
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.data import LmDataConfig, LmStream
from repro_torch.dist import api as dist
from repro_torch.models import transformer as ttr
from repro_torch.nn import moe as tmoe
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as ttl

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small tensors: the suite runs
    several test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
LM_ARCHS = ("kimi-k2-1t-a32b", "qwen3-moe-30b-a3b", "minicpm3-4b",
            "qwen3-0.6b", "qwen1.5-32b")
#: the JAX package's entry points, compiled once per config
j_decode = jax.jit(jtr.decode_step, static_argnums=1)
j_forward = jax.jit(jtr.forward, static_argnums=1)


def _j_loss_grads(jp, jcfg, batch):
    return jax.jit(jax.value_and_grad(
        lambda p, b: jtr.loss_fn(p, jcfg, b), has_aux=True))(jp, batch)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _configs(arch: str, embedding: str = "full", **over):
    return (j_get_arch(arch).make_config("smoke", embedding=embedding,
                                         **over),
            t_get_arch(arch).make_config("smoke", embedding=embedding,
                                         **{k: _torch_dtype(k, v)
                                            for k, v in over.items()}))


def _torch_dtype(key: str, v):
    return getattr(torch, jnp.dtype(v).name) if key.endswith("dtype") else v


def _params(jcfg, seed: int = 0):
    jp = jtr.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(vocab: int, b: int = 2, t: int = 16, seed: int = 1):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, vocab, (b, t)).astype(np.int32),
            rs.randint(0, vocab, (b, t)).astype(np.int32))


def _port_loss_grads(tp, tcfg, batch):
    flat, td = jax.tree_util.tree_flatten(
        tp, is_leaf=lambda x: isinstance(x, torch.Tensor))
    xs = [x.detach().requires_grad_(True) for x in flat]
    loss, m = ttr.loss_fn(jax.tree_util.tree_unflatten(td, xs), tcfg,
                          {k: _t(v) for k, v in batch.items()})
    gs = torch.autograd.grad(loss, xs)
    return float(loss.detach()), m, [g.numpy() for g in gs]


def _assert_grads_match(jgrads, tgrads):
    named = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(named) == len(tgrads)
    for (path, want), got in zip(named, tgrads):
        np.testing.assert_allclose(got, np.asarray(want), **TOL,
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# the five bundles end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("embedding", ("full", "robe"))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_logits_loss_and_grads_match_jax(arch, embedding):
    jcfg, tcfg = _configs(arch, embedding)
    jp, tp = _params(jcfg)
    toks, labels = _tokens(jcfg.vocab)
    tk.reset_launches()
    jl, ja = j_forward(jp, jcfg, jnp.asarray(toks))
    with torch.no_grad():
        tl, ta = ttr.forward(tp, tcfg, _t(toks))
    assert tl.shape == (2, 16, jcfg.vocab_padded)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), **TOL)
    batch = {"tokens": toks, "labels": labels}
    (jloss, jm), jg = _j_loss_grads(jp, jcfg, batch)
    tloss, tm, tg = _port_loss_grads(tp, tcfg, batch)
    np.testing.assert_allclose(tloss, float(jloss), **TOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL)
    _assert_grads_match(jg, tg)
    if embedding == "robe":
        names = [jax.tree_util.keystr(p)
                 for p, _ in jax.tree_util.tree_leaves_with_path(jg)]
        assert np.abs(tg[names.index("['embed']['memory']")]).sum() > 0
    assert all(v == 0 for v in tk.launch_counts().values())


@pytest.mark.parametrize("embedding", ("full", "robe"))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_chain_matches_jax(arch, embedding):
    """Prefill 5 tokens (``collect_cache``, ``logits_mode="last"``), then 6
    ``decode_step``s in both packages: the prefill's last logits and
    caches, and every step's logits and caches, within 1e-5."""
    jcfg, tcfg = _configs(arch, embedding, cache_dtype=jnp.float32)
    jp, tp = _params(jcfg)
    toks, _ = _tokens(jcfg.vocab, t=11, seed=3)
    s = toks.shape[1]
    jlast, _, jpre = jtr.forward(jp, jcfg, jnp.asarray(toks[:, :5]),
                                 collect_cache=True, logits_mode="last")
    tk.reset_launches()
    with torch.no_grad():
        tlast, _, tpre = ttr.forward(tp, tcfg, _t(toks[:, :5]),
                                     collect_cache=True, logits_mode="last")
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    assert sorted(tpre) == sorted(jpre)
    jcache, tcache = jtr.init_cache(jcfg, 2, s), ttr.init_cache(tcfg, 2, s,
                                                                 "cpu")
    assert len(jax.tree.leaves(jcache)) == len(jax.tree.leaves(
        tcache, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    jcache = _prefilled_jax(jcache, jpre)
    tcache = _prefilled_port(tcache, tpre)
    for t in range(5, s):
        jlg, jcache = j_decode(jp, jcfg, jcache, jnp.asarray(toks[:, t:t + 1]),
                               t)
        with torch.no_grad():
            tlg, tcache = ttr.decode_step(tp, tcfg, tcache,
                                          _t(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL,
                                   err_msg=f"step {t}")
    for a, b in zip(jax.tree.leaves(jcache), jax.tree.leaves(
            tree_to_numpy(tcache))):
        np.testing.assert_allclose(b, np.asarray(a), **TOL)
    assert all(v == 0 for v in tk.launch_counts().values())


def _prefilled_jax(cache, pre):
    """The prefill's keys and values written into slots 0..T-1."""
    def put(buf, val, seq_axis):
        idx = [slice(None)] * buf.ndim
        idx[seq_axis] = slice(0, val.shape[seq_axis])
        return buf.at[tuple(idx)].set(val.astype(buf.dtype))

    out = {"layers": {k: put(v, pre["layers"][k], 2)
                      for k, v in cache["layers"].items()}}
    if "dense_layers" in cache:
        out["dense_layers"] = [{k: put(v, p[k], 1) for k, v in c.items()}
                               for c, p in zip(cache["dense_layers"],
                                               pre["dense_layers"])]
    return out


def _prefilled_port(cache, pre):
    def put(buf, val, seq_axis):
        buf.narrow(seq_axis, 0, val.shape[seq_axis]).copy_(val)

    for k, v in cache["layers"].items():
        put(v, pre["layers"][k], 2)
    for c, p in zip(cache.get("dense_layers", []),
                    pre.get("dense_layers", [])):
        for k, v in c.items():
            put(v, p[k], 1)
    return cache


# ---------------------------------------------------------------------------
# MoE routing
# ---------------------------------------------------------------------------

def test_top_k_breaks_ties_toward_the_lower_index():
    rs = np.random.RandomState(0)
    probs = np.round(rs.rand(64, 16), 1).astype(np.float32)   # many ties
    probs[:8] = 0.25
    for k in (1, 2, 5, 16):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = tmoe.top_k(_t(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("n_shared", (0, 1))
@pytest.mark.parametrize("ties", (False, True))
def test_moe_dense_matches_jax(ties, n_shared):
    """Router gates, expert ids, aux loss, output and every gradient; with
    ``ties`` the router weights are zero, so every expert ties and the
    first top_k experts must be chosen, in index order."""
    kw = dict(d_model=24, d_ff=16, n_experts=6, top_k=3, n_shared=n_shared)
    jcfg, tcfg = jmoe.MoeConfig(**kw), tmoe.MoeConfig(**kw)
    jp = jmoe.moe_init(jax.random.PRNGKey(2), jcfg)
    if ties:
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.RandomState(3).randn(10, 24).astype(np.float32)
    jg, ji, ja = jmoe._router(jp, jcfg, jnp.asarray(x))
    tg, ti, ta = tmoe._router(tp, tcfg, _t(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), **TOL)
    if ties:
        assert (ti.numpy() == np.arange(3)).all()
    cot = np.random.RandomState(4).randn(10, 24).astype(np.float32)
    (jy, jaux), vjp = jax.vjp(
        lambda p, xx: jmoe.moe_apply_dense(p, jcfg, xx), jp, jnp.asarray(x))
    jgp, jgx = vjp((jnp.asarray(cot), jnp.ones((), jnp.float32)))
    flat, td = jax.tree_util.tree_flatten(
        tp, is_leaf=lambda v: isinstance(v, torch.Tensor))
    xs = [v.detach().requires_grad_(True) for v in flat]
    tx = _t(x).requires_grad_(True)
    ty, taux = tmoe.moe_apply_dense(jax.tree_util.tree_unflatten(td, xs),
                                    tcfg, tx)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    gs = torch.autograd.grad((ty * _t(cot)).sum() + taux, xs + [tx])
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(jgp),
                                 gs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=jax.tree_util.keystr(path))
    np.testing.assert_allclose(gs[-1].numpy(), np.asarray(jgx), **TOL)


# ---------------------------------------------------------------------------
# remat and scan_layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat,scan_layers", [(False, True), (True, True),
                                               (True, False), (False, False)])
def test_remat_and_scan_layers_match_jax(remat, scan_layers):
    """Every combination gives the JAX package's loss and gradients (the
    port's layers are one Python loop either way; remat recomputes them
    in the backward)."""
    over = dict(remat=remat, scan_layers=scan_layers)
    jcfg, tcfg = _configs("kimi-k2-1t-a32b", "robe", **over)
    jbase, _ = _configs("kimi-k2-1t-a32b", "robe")
    jp, tp = _params(jbase)
    toks, labels = _tokens(jcfg.vocab, seed=5)
    batch = {"tokens": toks, "labels": labels}
    (jloss, _), jg = _j_loss_grads(jp, jbase, batch)
    tloss, _, tg = _port_loss_grads(tp, tcfg, batch)
    np.testing.assert_allclose(tloss, float(jloss), **TOL)
    _assert_grads_match(jg, tg)


# ---------------------------------------------------------------------------
# configs, data
# ---------------------------------------------------------------------------

#: fields only the port's config has (for ``moonlight-16b-a3b``), each at
#: the default that computes what the JAX package computes
PORT_ONLY = {"moe_scoring": "softmax", "routed_scale": 1.0,
             "norm_eps": 1e-6}


def _fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    if isinstance(cfg, ttr.TransformerConfig):
        assert {k: out.pop(k) for k in PORT_ONLY} == PORT_ONLY
    for k, v in out.items():
        if isinstance(v, torch.dtype):
            out[k] = str(v).removeprefix("torch.")
        elif k.endswith("dtype"):
            out[k] = jnp.dtype(v).name
    return out


@pytest.mark.parametrize("variant", ("full", "smoke"))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_configs_match_jax(arch, variant):
    for emb in ("full", "robe"):
        for comp in (8, 64):
            j = j_get_arch(arch).make_config(variant, embedding=emb,
                                             robe_compression=comp)
            t = t_get_arch(arch).make_config(variant, embedding=emb,
                                             robe_compression=comp)
            assert _fields(t) == _fields(j)
            assert t.vocab_padded == j.vocab_padded
            assert t.param_count() == j.param_count()
            assert t.active_param_count() == j.active_param_count()
    tb, jb = t_get_arch(arch), j_get_arch(arch)
    assert (tb.kind, tb.notes != "") == (jb.kind, jb.notes != "")
    assert tb.shapes == jb.shapes == LM_SHAPES


def test_qwen3_robe_sizes():
    """The card's qwen3-0.6b cells: 752M params, vocab padded to 152,064,
    and a ROBE array of vocab·d/8 slots (from ``vocab``, not the padded
    one)."""
    cfg = t_get_arch("qwen3-0.6b").make_config("full", embedding="robe")
    assert cfg.vocab_padded == 152_064 and cfg.robe_size == 19_447_808
    assert cfg.param_count() == 751_566_848


@pytest.mark.parametrize("step", (0, 1, 17))
def test_lm_stream_matches_jax(step):
    for kw in (dict(vocab=2048, seq_len=64, batch_size=16),
               dict(vocab=151936, seq_len=33, batch_size=3, seed=5)):
        j, t = JLmStream(JLmDataConfig(**kw)), LmStream(LmDataConfig(**kw))
        assert (t.a, t.c) == (j.a, j.c)
        jb, tb = j.batch_at(step), t.batch_at(step)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert tb[k].dtype == jb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k])


@pytest.fixture(scope="module")
def one_rank_mesh(tmp_path_factory):
    """A world of this one process (gloo) and the (1, 1) ("data",
    "model") mesh on it: every sharded path of the LM runs, each
    collective a copy."""
    import torch.distributed as tdist

    from repro_torch.launch.mesh import make_mesh
    path = tmp_path_factory.mktemp("pg") / "store"
    tdist.init_process_group("gloo", init_method=f"file://{path}", rank=0,
                             world_size=1)
    try:
        yield dist.DistContext(mesh=make_mesh((1, 1), ("data", "model"),
                                              device="cpu"),
                               rules=dist.default_rules())
    finally:
        tdist.destroy_process_group()


@pytest.mark.parametrize("arch", ("qwen3-0.6b", "minicpm3-4b"))
def test_mesh_guard_raises(one_rank_mesh, arch):
    """The mesh guard: under an active context the entry points run the
    sharded LM (tensor, expert and sequence parallelism) and raise
    nothing; on a one-rank mesh ``forward``, ``loss_fn`` (with its
    gradients) and a prefill + ``decode_step`` chain match the same calls
    without a context."""
    jcfg, tcfg = _configs(arch, cache_dtype=jnp.float32)
    _, tp = _params(jcfg)
    toks, labels = (_t(x) for x in _tokens(jcfg.vocab))
    batch = {"tokens": toks, "labels": labels}
    runs = []
    for ctx in (None, one_rank_mesh):
        with dist.use(ctx) if ctx else contextlib.nullcontext():
            with torch.no_grad():
                logits, aux = ttr.forward(tp, tcfg, toks)
                _, _, pre = ttr.forward(tp, tcfg, toks[:, :12],
                                        collect_cache=True,
                                        logits_mode="last")
                cache = ttr.fill_cache(tcfg, ttr.init_cache(
                    tcfg, 2, 16, "cpu"), pre, 12)
                steps = [ttr.decode_step(tp, tcfg, cache, toks[:, t:t + 1],
                                         t)[0] for t in range(12, 16)]
            loss, m, grads = _port_loss_grads(tp, tcfg, batch)
        runs.append((logits, aux, loss, grads, steps))
    (l0, a0, s0, g0, d0), (l1, a1, s1, g1, d1) = runs
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), **TOL)
    np.testing.assert_allclose(float(a1), float(a0), **TOL)
    np.testing.assert_allclose(s1, s0, **TOL)
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(b, a, **TOL)
    for a, b in zip(d0, d1):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **TOL)


# ---------------------------------------------------------------------------
# examples/lm_robe_embedding.py in both packages
# ---------------------------------------------------------------------------

def _example_cfg(mod, dtype, embedding: str):
    vocab, d = 2048, 64
    return mod.TransformerConfig(
        name=f"lm-{embedding}", n_layers=2, d_model=d, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=vocab, q_chunk=0,
        embedding=embedding, robe_size=vocab * d // 8, robe_block=32,
        compute_dtype=dtype, remat=False)


def _add_update_err(acc: dict, old, new_port, new_jax) -> None:
    names = jax.tree.leaves(jax.tree_util.tree_map_with_path(
        lambda path, _: jax.tree_util.keystr(path), old))
    for name, o, t, j in zip(names, jax.tree.leaves(old),
                             jax.tree.leaves(new_port),
                             jax.tree.leaves(new_jax)):
        o = np.asarray(o, np.float64)
        want = np.asarray(j, np.float64) - o
        diff = np.asarray(t, np.float64) - o - want
        d, w = acc.get(name, (0.0, 0.0))
        acc[name] = (d + float(np.sum(diff * diff)),
                     w + float(np.sum(want * want)))


@pytest.mark.parametrize("embedding", ("full", "robe"))
def test_lm_robe_embedding_example(embedding):
    """120 adam steps (lr 2e-3, B=16, T=64) of the example's config: each
    port step from the JAX run's state before it, its loss within 1e-5
    and each param leaf's updates within 1e-4 of their norm over the run
    (the losses fall by more than 0.5 nats)."""
    jcfg = _example_cfg(jtr, jnp.float32, embedding)
    tcfg = _example_cfg(ttr, torch.float32, embedding)
    jp = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    opt = dict(kind="adam", lr=2e-3)
    jo = jopt.make_optimizer(jopt.OptimizerConfig(**opt))
    to = topt.make_optimizer(topt.OptimizerConfig(**opt))
    jc = jtl.TrainConfig(checkpoint_every=10 ** 9)
    tc = ttl.TrainConfig(checkpoint_every=10 ** 9)
    jstep = jtl.build_train_step(lambda p, b: jtr.loss_fn(p, jcfg, b), jo,
                                 jc)
    tstep = ttl.build_train_step(lambda p, b: ttr.loss_fn(p, tcfg, b), to,
                                 tc)
    stream = LmStream(LmDataConfig(vocab=2048, seq_len=64, batch_size=16))
    jstream = JLmStream(JLmDataConfig(vocab=2048, seq_len=64,
                                      batch_size=16))
    before = []

    def recorded(state, batch):
        before.append(jax.tree.map(np.asarray, state))
        return jstep(state, batch)

    n = 120
    jrep = jtl.run(jtl.init_state(jp, jo, jc), recorded, jstream.batch_at,
                   n, jc)
    assert jrep.steps_done == len(before) == n
    after = before[1:] + [jax.tree.map(np.asarray, jrep.state)]
    diffs, acc = [], {}
    tk.reset_launches()
    for k, (old, new) in enumerate(zip(before, after)):
        got, m = tstep(params_from_numpy(old, "cpu"),
                       {key: _t(v) for key, v in stream.batch_at(k).items()})
        diffs.append(abs(float(m["loss"]) - jrep.losses[k]))
        _add_update_err(acc, old["params"], tree_to_numpy(got["params"]),
                        new["params"])
    rel = {name: (d / w) ** 0.5 for name, (d, w) in acc.items() if w > 0}
    print(f"{embedding}: JAX loss {jrep.losses[0]:.4f} -> "
          f"{jrep.losses[-1]:.4f}; max step loss diff {max(diffs):.3e}, "
          f"update error {max(rel.values()):.3e}")
    assert max(diffs) <= 1e-5, (max(diffs), int(np.argmax(diffs)))
    assert max(rel.values()) <= 1e-4, rel
    assert jrep.losses[-1] < jrep.losses[0] - 0.5
    assert all(v == 0 for v in tk.launch_counts().values())
