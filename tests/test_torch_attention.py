"""The port's attention and norms against the JAX package, on the CPU.

RoPE, chunked causal attention, GQA (with qk-norm and qkv-bias) and MLA
(the expanded train/prefill form and the absorbed decode against the
latent cache): outputs and every input and weight gradient (a vector-
Jacobian product with one random cotangent) within rtol = atol = 1e-5 in
f32; decode against the forward, the prefill cache against the decode
cache, and int8-cache decode.  The rms, layer and batch norms' forward and
``_rms_bwd``'s gradients are held in f32 at 1e-5 and in bf16 at 1e-2.
Inputs are made from a seed with numpy and fed to both packages; params
come from ``repro``'s init.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtr
from repro.nn import attention as jatt
from repro.nn import core as jcore
from repro_torch.convert import params_from_numpy
from repro_torch.models import transformer as ttr
from repro_torch.nn import attention as tatt
from repro_torch.nn import core as tcore

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small tensors: the suite runs
    several test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
#: the JAX package's decode step, compiled once per config
j_decode = jax.jit(jtr.decode_step, static_argnums=1)


def _t(x, dtype=None):
    t = torch.from_numpy(np.asarray(x))
    return t if dtype is None else t.to(dtype)


def _np(t):
    t = t.detach()
    return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()


def _params(init, key=0):
    jp = init(jax.random.PRNGKey(key))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _port_vjp(fn, tparams, targs, cot):
    """fn(params, *args) -> out; (out, grads of the params' float leaves,
    grads of the float args) for the cotangent ``cot``."""
    flat, td = jax.tree_util.tree_flatten(
        tparams, is_leaf=lambda x: isinstance(x, torch.Tensor))
    xs = [x.detach().requires_grad_(True) for x in flat]
    args = [a.detach().requires_grad_(True) if a.is_floating_point() else a
            for a in targs]
    out = fn(jax.tree_util.tree_unflatten(td, xs), *args)
    live = xs + [a for a in args if a.requires_grad]
    gs = torch.autograd.grad(out, live, grad_outputs=_t(cot, out.dtype),
                             allow_unused=True)
    gs = [torch.zeros_like(x) if g is None else g for x, g in zip(live, gs)]
    return out, gs[:len(xs)], gs[len(xs):]


def _jax_vjp(fn, jparams, jargs, cot):
    floats = [i for i, a in enumerate(jargs)
              if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)]

    def f(p, *fl):
        args = list(jargs)
        for i, a in zip(floats, fl):
            args[i] = a
        return fn(p, *args)

    out, vjp = jax.vjp(f, jparams, *[jargs[i] for i in floats])
    g = vjp(jnp.asarray(cot, out.dtype))
    return out, jax.tree.leaves(g[0]), list(g[1:])


def _assert_vjp_match(jfn, tfn, jp, tp, args, seed=1, tol=TOL):
    """Outputs and every gradient of ``jfn``/``tfn`` on the same inputs."""
    jargs = [jnp.asarray(a) for a in args]
    targs = [_t(a) for a in args]
    jout = jfn(jp, *jargs)
    cot = np.random.RandomState(seed).randn(*jout.shape).astype(np.float32)
    jout, jgp, jga = _jax_vjp(jfn, jp, jargs, cot)
    tout, tgp, tga = _port_vjp(tfn, tp, targs, cot)
    np.testing.assert_allclose(_np(tout), np.asarray(jout, np.float32),
                               **tol)
    assert len(jgp) == len(tgp) and len(jga) == len(tga)
    for path, (a, b) in zip(jax.tree_util.tree_leaves_with_path(jp),
                            zip(jgp, tgp)):
        np.testing.assert_allclose(_np(b), np.asarray(a, np.float32), **tol,
                                   err_msg=jax.tree_util.keystr(path[0]))
    for a, b in zip(jga, tga):
        np.testing.assert_allclose(_np(b), np.asarray(a, np.float32), **tol)


# ---------------------------------------------------------------------------
# RoPE and chunked attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim,theta", [(16, 1e4), (8, 1e6), (128, 1e6)])
def test_rope_matches_jax(dim, theta):
    rs = np.random.RandomState(0)
    pos = np.arange(0, 4096, 37, dtype=np.int32)
    jc, js = jatt.rope_cos_sin(jnp.asarray(pos), dim, theta)
    tc, ts = tatt.rope_cos_sin(_t(pos), dim, theta)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    x = rs.randn(2, len(pos), 3, dim).astype(np.float32)
    want = jatt.apply_rope(jnp.asarray(x), jc, js)
    got = tatt.apply_rope(_t(x), tc, ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("q_chunk", [0, 16, 48])
@pytest.mark.parametrize("kv", [1, 4, 8])
def test_chunked_attention_matches_jax(q_chunk, kv):
    """Chunked (or, where q_chunk does not divide T, unchunked) causal
    attention and its gradients against the JAX package's."""
    rs = np.random.RandomState(kv)
    b, t, h, d = 2, 64, 8, 16
    q, k, v = (rs.randn(b, t, n, d).astype(np.float32)
               for n in (h, kv, kv))

    def jfn(_, q, k, v):
        return jatt.chunked_attention(q, k, v, kv, q_chunk)

    def tfn(_, q, k, v):
        return tatt.chunked_attention(q, k, v, kv, q_chunk)

    _assert_vjp_match(jfn, tfn, {}, {}, [q, k, v])


def test_chunked_equals_unchunked():
    rs = np.random.RandomState(0)
    b, t, h, kv, d = 2, 64, 8, 4, 16
    q = _t(rs.randn(b, t, h, d).astype(np.float32))
    k = _t(rs.randn(b, t, kv, d).astype(np.float32))
    v = _t(rs.randn(b, t, kv, d).astype(np.float32))
    full = tatt.chunked_attention(q, k, v, kv, 0)
    chunked = tatt.chunked_attention(q, k, v, kv, 16)
    np.testing.assert_allclose(chunked.numpy(), full.numpy(), **TOL)


def test_masked_decode_attention_matches_jax():
    """Non-causal attention with per-row ``kv_len`` (the decode form)."""
    rs = np.random.RandomState(3)
    q = rs.randn(3, 1, 4, 8).astype(np.float32)
    k = rs.randn(3, 20, 2, 8).astype(np.float32)
    v = rs.randn(3, 20, 2, 8).astype(np.float32)
    kv_len = np.array([1, 7, 20], np.int32)
    want = jatt.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), 2, 0, causal=False,
                                  kv_len=jnp.asarray(kv_len))
    got = tatt.chunked_attention(_t(q), _t(k), _t(v), 2, 0, causal=False,
                                 kv_len=_t(kv_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# GQA and MLA blocks: forward and every gradient
# ---------------------------------------------------------------------------

GQA_CASES = {
    "gqa": dict(d_model=48, n_heads=4, n_kv_heads=2, head_dim=12,
                q_chunk=4),
    "gqa_qk_norm": dict(d_model=48, n_heads=4, n_kv_heads=2, head_dim=12,
                        qk_norm=True, q_chunk=4),
    "mha_qkv_bias": dict(d_model=32, n_heads=4, n_kv_heads=4, head_dim=8,
                         qkv_bias=True, q_chunk=0),
    "mqa": dict(d_model=32, n_heads=4, n_kv_heads=1, head_dim=8,
                qk_norm=True, qkv_bias=True, q_chunk=8),
}
MLA_CASE = dict(d_model=48, n_heads=4, n_kv_heads=4, head_dim=12,
                kind="mla", q_lora_rank=24, kv_lora_rank=16, qk_nope_dim=12,
                qk_rope_dim=8, v_head_dim=12, q_chunk=4)
CASES = dict(GQA_CASES, mla=MLA_CASE)


def _attn(case: str):
    kw = dict(CASES[case], rope_theta=1e4)
    jcfg, tcfg = jatt.AttnConfig(**kw), tatt.AttnConfig(**kw)
    jp, tp = _params(lambda k: jatt.attention_init(k, jcfg))
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("case", list(CASES))
def test_attention_block_and_grads_match_jax(case):
    jcfg, tcfg, jp, tp = _attn(case)
    rs = np.random.RandomState(5)
    x = rs.randn(2, 16, jcfg.d_model).astype(np.float32)
    pos = np.arange(16, dtype=np.int32)

    def jfn(p, x, pos):
        return jatt.attention_apply(p, jcfg, x, pos)[0]

    def tfn(p, x, pos):
        return tatt.attention_apply(p, tcfg, x, pos)[0]

    _assert_vjp_match(jfn, tfn, jp, tp, [x, pos])


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_kv_matches_jax(case):
    jcfg, tcfg, jp, tp = _attn(case)
    x = np.random.RandomState(6).randn(2, 8, jcfg.d_model).astype(
        np.float32)
    pos = np.arange(8, dtype=np.int32)
    _, jkv = jatt.attention_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                  return_kv=True)
    _, tkv = tatt.attention_apply(tp, tcfg, _t(x), _t(pos), return_kv=True)
    assert sorted(jkv) == sorted(tkv)
    for k in jkv:
        np.testing.assert_allclose(_np(tkv[k]), np.asarray(jkv[k]), **TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("case", list(CASES))
def test_decode_steps_match_jax(case, dtype):
    """Decode steps against the same steps of the JAX package, cache for
    cache (MLA takes no int8: a bf16 cache instead)."""
    jcfg, tcfg, jp, tp = _attn(case)
    b, s = 2, 6
    jc = jatt.init_cache(jcfg, b, s, getattr(jnp, dtype))
    tc = tatt.init_cache(tcfg, b, s, getattr(torch, dtype), "cpu")
    assert sorted(jc) == sorted(tc)
    for k in jc:
        assert tuple(jc[k].shape) == tuple(tc[k].shape)
        assert np.dtype(jc[k].dtype).name == str(tc[k].dtype).split(".")[1]
    rs = np.random.RandomState(7)
    for t in range(s):
        x = rs.randn(b, 1, jcfg.d_model).astype(np.float32)
        pos = np.full((1,), t, np.int32)
        kv_len = np.full((b,), t + 1, np.int32)
        jo, jc = jatt.attention_apply(jp, jcfg, jnp.asarray(x),
                                      jnp.asarray(pos), cache=jc,
                                      kv_len=jnp.asarray(kv_len))
        with torch.no_grad():
            to, tc = tatt.attention_apply(tp, tcfg, _t(x), _t(pos), cache=tc,
                                          kv_len=_t(kv_len))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        for k in jc:
            if tc[k].dtype == torch.int8:
                np.testing.assert_array_equal(tc[k].numpy(),
                                              np.asarray(jc[k]))
            else:
                np.testing.assert_allclose(_np(tc[k]),
                                           np.asarray(jc[k], np.float32),
                                           **TOL)


def test_int8_quantiser_rounds_half_to_even():
    """Codes at exact .5 ties round to even, as ``jnp.round``; clipped to
    ±127."""
    val = np.array([[[254.0, 1.0, -3.0, 5.0, 127.0, -254.0]]], np.float32)
    codes, scale = tatt._q8(_t(val))
    s = np.abs(val).max(-1) / 127.0 + 1e-12
    want = np.clip(np.round(val / s[..., None]), -127, 127)
    np.testing.assert_array_equal(codes.numpy(), want.astype(np.int8))
    np.testing.assert_allclose(scale.numpy(), s.astype(np.float32))
    half = tatt._q8(_t(np.array([[[2.5, 0.5, 1.5, -0.5, 127.0]]],
                                np.float32)))[0]
    assert half.tolist() == [[[2, 0, 2, 0, 127]]]


# ---------------------------------------------------------------------------
# whole-model decode: against the forward, and the prefill cache
# ---------------------------------------------------------------------------

LM_CASES = {
    "gqa": dict(name="t", n_layers=2, d_model=48, n_heads=4, n_kv_heads=2,
                head_dim=12, d_ff=96, vocab=128, qk_norm=True, q_chunk=4),
    "mla": dict(name="m", n_layers=2, d_model=48, n_heads=4, n_kv_heads=4,
                head_dim=12, d_ff=96, vocab=128, attn_kind="mla",
                q_lora_rank=24, kv_lora_rank=16, qk_nope_dim=12,
                qk_rope_dim=8, v_head_dim=12, q_chunk=0),
    "qkv_bias": dict(name="b", n_layers=2, d_model=32, n_heads=4,
                     n_kv_heads=4, head_dim=8, d_ff=64, vocab=64,
                     qkv_bias=True, q_chunk=0),
}


def _lm(case: str, cache_dtype: str = "float32"):
    kw = dict(LM_CASES[case], remat=False)
    jcfg = jtr.TransformerConfig(**kw, compute_dtype=jnp.float32,
                                 cache_dtype=getattr(jnp, cache_dtype))
    tcfg = ttr.TransformerConfig(**kw, compute_dtype=torch.float32,
                                 cache_dtype=getattr(torch, cache_dtype))
    jp, tp = _params(lambda k: jtr.init_params(k, jcfg))
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("case", list(LM_CASES))
def test_decode_matches_forward(case):
    """decode_step token by token == the full forward (the JAX package's
    own bound, 2e-4), and each step's logits within 1e-5 of its decode."""
    jcfg, tcfg, jp, tp = _lm(case)
    toks = np.random.RandomState(1).randint(0, jcfg.vocab, (2, 12)).astype(
        np.int32)
    with torch.no_grad():
        full = ttr.forward(tp, tcfg, _t(toks))[0].numpy()
        cache = ttr.init_cache(tcfg, 2, 12, "cpu")
        jcache = jtr.init_cache(jcfg, 2, 12)
        for t in range(12):
            lg, cache = ttr.decode_step(tp, tcfg, cache, _t(toks[:, t:t + 1]),
                                        t)
            jlg, jcache = j_decode(jp, jcfg, jcache,
                                          jnp.asarray(toks[:, t:t + 1]), t)
            np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
            assert np.abs(lg.numpy() - full[:, t]).max() < 2e-4


@pytest.mark.parametrize("case", list(LM_CASES))
def test_prefill_cache_matches_decode_cache(case):
    """forward(collect_cache) then one decode step == decoding all along,
    and the prefill cache equals the JAX package's."""
    jcfg, tcfg, jp, tp = _lm(case)
    toks = np.random.RandomState(2).randint(0, jcfg.vocab, (2, 9)).astype(
        np.int32)
    with torch.no_grad():
        last, _, cache = ttr.forward(tp, tcfg, _t(toks[:, :8]),
                                     collect_cache=True, logits_mode="last")
        _, _, jcache = jtr.forward(jp, jcfg, jnp.asarray(toks[:, :8]),
                                   collect_cache=True, logits_mode="last")
        for k in jcache["layers"]:
            np.testing.assert_allclose(cache["layers"][k].numpy(),
                                       np.asarray(jcache["layers"][k]), **TOL)
        cache = {"layers": {k: torch.nn.functional.pad(
            v, [0, 0] * (v.dim() - 3) + [0, 1]) for k, v in
            cache["layers"].items()}}
        lg, _ = ttr.decode_step(tp, tcfg, cache, _t(toks[:, 8:9]), 8)
        full = ttr.forward(tp, tcfg, _t(toks))[0].numpy()
    np.testing.assert_allclose(lg.numpy(), full[:, -1], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(last.numpy(), full[:, 7], rtol=1e-4,
                               atol=1e-4)


def test_int8_kv_cache_decode_matches_jax_and_forward():
    """The int8 cache: every step's logits within 1e-5 of the JAX
    package's int8 decode, and within its quantisation bound (0.05) of the
    exact forward."""
    jcfg, tcfg, jp, tp = _lm("gqa", "int8")
    toks = np.random.RandomState(1).randint(0, 128, (2, 12)).astype(np.int32)
    with torch.no_grad():
        full = ttr.forward(tp, tcfg, _t(toks))[0].numpy()
        cache = ttr.init_cache(tcfg, 2, 12, "cpu")
        assert cache["layers"]["k"].dtype == torch.int8
        jcache = jtr.init_cache(jcfg, 2, 12)
        for t in range(12):
            lg, cache = ttr.decode_step(tp, tcfg, cache, _t(toks[:, t:t + 1]),
                                        t)
            jlg, jcache = j_decode(jp, jcfg, jcache,
                                          jnp.asarray(toks[:, t:t + 1]), t)
            np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
            assert np.abs(lg.numpy() - full[:, t]).max() < 0.05
        np.testing.assert_array_equal(cache["layers"]["k"].numpy(),
                                      np.asarray(jcache["layers"]["k"]))


def test_mla_cache_takes_no_int8():
    cfg = tatt.AttnConfig(**MLA_CASE)
    c = tatt.init_cache(cfg, 2, 5, torch.int8, "cpu")
    assert {k: v.dtype for k, v in c.items()} == {"c_kv": torch.bfloat16,
                                                  "k_rope": torch.bfloat16}
    assert c["c_kv"].shape == (2, 5, 16) and c["k_rope"].shape == (2, 5, 8)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

NORMS = {
    "rms": (jcore.rms_norm_init, jcore.rms_norm_apply,
            tcore.rms_norm_apply),
    "layer": (jcore.layer_norm_init, jcore.layer_norm_apply,
              tcore.layer_norm_apply),
    "batch": (jcore.batch_norm_init, jcore.batch_norm_apply,
              tcore.batch_norm_apply),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", list(NORMS))
def test_norms_and_grads_match_jax(norm, dtype):
    """Forward and the gradients of the gain (and bias) and of x; the rms
    norm's backward is ``_rms_bwd``'s formula (dx in x's dtype, dg in
    f32)."""
    init, japply, tapply = NORMS[norm]
    rs = np.random.RandomState(4)
    jp = jax.tree.map(lambda a: a + jnp.asarray(
        rs.randn(*a.shape).astype(np.float32) * 0.1), init(24))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = (rs.randn(3, 5, 24) * 2 + 0.5).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, tx = jnp.asarray(x).astype(jdt), _t(x).to(tdt)
    cot = rs.randn(3, 5, 24).astype(np.float32)
    jout, vjp = jax.vjp(lambda p, xx: japply(p, xx), jp, jx)
    jgp, jgx = vjp(jnp.asarray(cot).astype(jdt))
    tpx = {k: v.detach().requires_grad_(True) for k, v in tp.items()}
    txx = tx.detach().requires_grad_(True)
    tout = tapply(tpx, txx)
    assert tout.dtype == tdt
    gs = torch.autograd.grad(tout, [tpx[k] for k in sorted(tpx)] + [txx],
                             grad_outputs=_t(cot).to(tdt))
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(tout), np.asarray(jout, np.float32), **tol)
    for k, g in zip(sorted(tpx), gs):
        np.testing.assert_allclose(_np(g), np.asarray(jgp[k], np.float32),
                                   **tol, err_msg=k)
    assert gs[-1].dtype == tdt
    np.testing.assert_allclose(_np(gs[-1]), np.asarray(jgx, np.float32),
                               **tol)


def test_rms_backward_is_the_custom_formula_not_autograd():
    """In bf16 the custom backward (f32 internals, one rounding) differs
    from autograd of the forward; the port follows ``_rms_bwd``."""
    rs = np.random.RandomState(8)
    x = _t(rs.randn(64, 128).astype(np.float32) * 3).to(torch.bfloat16)
    g = torch.ones(128) + _t(rs.randn(128).astype(np.float32)) * 0.1
    cot = _t(rs.randn(64, 128).astype(np.float32)).to(torch.bfloat16)
    xr = x.detach().requires_grad_(True)
    gx = torch.autograd.grad(tcore.rms_norm_apply({"g": g}, xr), xr, cot)[0]
    jgx = jax.vjp(lambda xx: jcore.rms_norm_apply({"g": jnp.asarray(
        g.numpy())}, xx), jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16))[1](jnp.asarray(cot.float().numpy()).astype(
            jnp.bfloat16))[0]
    np.testing.assert_array_equal(_np(gx), np.asarray(jgx, np.float32))
