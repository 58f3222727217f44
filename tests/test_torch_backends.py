"""The port's ``full``, ``qrobe``, ``hashed`` and ``tt`` embedding backends
against the JAX package's.

The layout helpers and the int8 quantizer must give the same numbers as
``repro``'s; ``param_count`` and ``cost`` must agree at the full
``dlrm-criteo-tb`` width; ``init`` must build the same tree (keys, shapes,
dtypes); and ``lookup`` on JAX-initialised params carried over by
``convert.params_from_numpy`` must equal the JAX backend's lookup on the
CPU, where the port runs its plain versions.  full, qrobe and hashed lookups
are gathers (and one f32 product), so they match exactly; tt contracts a
chain whose sums run in another order, so within rtol = atol = 1e-5.
``full``'s ``cacheable_rows`` must give the rows its lookup gathers, bit for
bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.core.robe import RobeSpec as JRobeSpec
from repro.models import recsys as jrec
from repro.nn.embedding_backends import hashed as jhashed
from repro.nn.embedding_backends import qrobe as jqrobe
from repro.nn.embedding_backends import tt as jtt
from repro.nn.embeddings import EmbeddingSpec as JSpec
from repro.nn.embeddings import get_backend as j_get_backend
from repro_torch import kernels as tk
from repro_torch.configs.registry import get_arch as t_get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.models import recsys as trec
from repro_torch.core.robe import RobeSpec as TRobeSpec
from repro_torch.nn.embedding_backends import hashed as thashed
from repro_torch.nn.embedding_backends import qrobe as tqrobe
from repro_torch.nn.embedding_backends import tt as ttt
from repro_torch.nn.embeddings import EmbeddingSpec as TSpec
from repro_torch.nn.embeddings import get_backend

KINDS = ("full", "qrobe", "hashed", "tt")
VOCABS = (400, 240, 640)


@pytest.fixture(autouse=True)
def _no_launches():
    """Every test here runs on the CPU: no kernel may be launched."""
    tk.reset_launches()
    yield
    assert all(n == 0 for n in tk.launch_counts().values())


def _specs(kind: str, dim: int = 8, **kw):
    robe = dict(size=2048, block_size=8, seed=3, use_sign=True)
    return (JSpec(vocab_sizes=VOCABS, dim=dim, kind=kind,
                  robe=JRobeSpec(**robe), **kw),
            TSpec(vocab_sizes=VOCABS, dim=dim, kind=kind,
                  robe=TRobeSpec(**robe), **kw))


def _carry(params: dict) -> dict:
    return params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


def _ids(b: int, seed: int) -> np.ndarray:
    rs = np.random.RandomState(seed)
    idx = np.stack([rs.randint(0, v, b) for v in VOCABS], axis=1)
    idx[-1] = np.asarray(VOCABS) - 1              # each field's largest id
    return idx.astype(np.int32)


# ---------------------------------------------------------------------------
# layout helpers and the int8 quantizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocabs", [VOCABS, (40, 24, 64), (3,), (1, 2),
                                    (10 ** 6, 17, 5000)])
def test_qr_layout_matches_jax(vocabs):
    assert thashed.default_buckets(vocabs) == jhashed.default_buckets(vocabs)
    for m in (2, 7, 8, thashed.default_buckets(vocabs)):
        got, want = thashed.qr_layout(vocabs, m), jhashed.qr_layout(vocabs, m)
        assert got[0] == want[0]
        assert np.array_equal(got[1], want[1]) and got[1].dtype == want[1].dtype
        assert np.array_equal(got[2], want[2]) and got[2].dtype == want[2].dtype


@pytest.mark.parametrize("n", [1, 2, 7, 128, 1000, 1304, 204_184_588])
def test_factor_rows_matches_jax(n):
    assert ttt.factor_rows(n) == jtt.factor_rows(n)
    n1, n2, n3 = ttt.factor_rows(n)
    assert n1 * n2 * n3 >= n


@pytest.mark.parametrize("d", [1, 7, 8, 16, 24, 64, 128, 96])
def test_factor_dim_matches_jax(d):
    assert ttt.factor_dim(d) == jtt.factor_dim(d)
    assert int(np.prod(ttt.factor_dim(d))) == d


def test_group_constants_match_jax():
    assert (tqrobe.GROUP_SIZE, tqrobe.GROUP_LOG2, tqrobe.SCALE_FLOOR) == \
        (jqrobe.GROUP_SIZE, jqrobe.GROUP_LOG2, jqrobe.SCALE_FLOOR)
    for size in (1, 255, 256, 257, 26_135_627):
        assert tqrobe.n_groups(size) == jqrobe.n_groups(size)


def _quantize_both(w: np.ndarray, scale: np.ndarray):
    tc, ts = tqrobe.quantize_array(torch.from_numpy(w),
                                   torch.from_numpy(scale))
    jc, js = jqrobe.quantize_array(jnp.asarray(w), jnp.asarray(scale))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    return tc.numpy(), ts.numpy()


def test_quantize_array_matches_jax_on_random_groups():
    rs = np.random.RandomState(0)
    w = (rs.randn(1000) * 0.02).astype(np.float32)
    scale = (np.abs(rs.randn(4)) * 1e-3).astype(np.float32)
    scale[1] = -scale[1]                           # a learned negative scale
    _quantize_both(w, scale)


def test_quantize_saturates_at_127():
    """Values beyond ±127·scale clip, they do not wrap."""
    codes, _ = _quantize_both(
        np.asarray([10.0, -10.0, 1.27, -1.27, 0.0], np.float32),
        np.full((1,), 0.01, np.float32))
    assert codes.tolist() == [127, -127, 127, -127, 0]


def test_quantize_floors_collapsed_scales_keeping_their_sign():
    for s in (0.0, 1e-30, -1e-30):
        codes, safe = _quantize_both(np.ones(3, np.float32),
                                     np.asarray([s], np.float32))
        assert np.all(np.abs(safe) >= tqrobe.SCALE_FLOOR)
        assert (safe[0] < 0) == (s < 0)
        assert np.abs(codes).max() == 127


def test_quantize_rounds_half_to_even():
    """torch.round and jnp.round both round half to even."""
    codes, _ = _quantize_both(
        np.asarray([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5], np.float32),
        np.ones((1,), np.float32))
    assert codes.tolist() == [0, 2, 2, 0, -2, -2, 4]


# ---------------------------------------------------------------------------
# param_count and cost at the full dlrm-criteo-tb width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_param_count_and_cost_match_jax_at_full_width(kind):
    jspec = j_get_arch("dlrm-criteo-tb").make_config(
        "full", embedding=kind).embedding_spec()
    tspec = t_get_arch("dlrm-criteo-tb").make_config(
        "full", embedding=kind).embedding_spec()
    assert tspec.param_count == jspec.param_count
    assert tspec.compression == pytest.approx(jspec.compression)
    for b in (512, 262_144):
        assert get_backend(kind).cost(tspec, b) == \
            j_get_backend(kind).cost(jspec, b)


def test_full_width_sizes():
    """The parameters a card holds at dlrm-criteo-tb width."""
    specs = {k: t_get_arch("dlrm-criteo-tb").make_config(
        "full", embedding=k).embedding_spec() for k in KINDS}
    assert specs["qrobe"].param_count == 26_135_627 + 102_093
    m = thashed.default_buckets(specs["hashed"].vocab_sizes)
    q_rows, _, _ = thashed.qr_layout(specs["hashed"].vocab_sizes, m)
    assert (m, sum(q_rows)) == (8192, 24_941)
    assert ttt.factor_rows(specs["tt"].total_rows) == (589, 589, 589)
    assert ttt.factor_dim(128) == (2, 8, 8)


# ---------------------------------------------------------------------------
# init trees and lookups on carried-over params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_init_tree_matches_jax(kind):
    """Same keys, shapes and dtypes leaf by leaf; draws are seeded."""
    jspec, tspec = _specs(kind, hashed_buckets=0, tt_rank=0)
    jp = j_get_backend(kind).init(jax.random.PRNGKey(0), jspec)
    tp = get_backend(kind).init(torch.Generator().manual_seed(0), tspec,
                                "cpu")
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == tuple(jp[k].shape), k
        assert tp[k].numpy().dtype == np.asarray(jp[k]).dtype, k
    again = get_backend(kind).init(torch.Generator().manual_seed(0), tspec,
                                   "cpu")
    assert all(torch.equal(again[k], tp[k]) for k in tp)


def test_qrobe_init_is_calibrated():
    """Codes reach ±127 in every group and dequantize to within half a
    step of the f32 array robe would have drawn."""
    _, tspec = _specs("qrobe")
    gen = torch.Generator().manual_seed(1)
    p = get_backend("qrobe").init(gen, tspec, "cpu")
    w = get_backend("robe").init(torch.Generator().manual_seed(1), tspec,
                                 "cpu")["memory"]
    deq = tqrobe._expand(p["scale"], w.shape[0]) * p["codes"].float()
    step = tqrobe._expand(p["scale"], w.shape[0])
    assert torch.all((deq - w).abs() <= step / 2 + 1e-12)
    assert p["codes"].view(-1, tqrobe.GROUP_SIZE).abs().amax(1).eq(127).all()
    assert not p["delta"].any()


@pytest.mark.parametrize("kind,kw", [
    ("full", {}), ("qrobe", {}), ("hashed", {}),
    ("hashed", dict(hashed_buckets=7)),
    ("tt", {}), ("tt", dict(tt_rank=4)),
])
@pytest.mark.parametrize("b", (16, 13))
def test_lookup_matches_jax(kind, kw, b):
    jspec, tspec = _specs(kind, **kw)
    jp = j_get_backend(kind).init(jax.random.PRNGKey(b), jspec)
    idx = _ids(b, seed=b)
    got = get_backend(kind).lookup(_carry(jp), tspec, torch.from_numpy(idx))
    want = np.asarray(j_get_backend(kind).lookup(jp, jspec,
                                                 jnp.asarray(idx)))
    assert got.shape == want.shape and got.dtype == torch.float32
    if kind == "tt":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def test_lookup_matches_jax_kernel_path():
    """The JAX side through its Pallas kernels (interpret mode)."""
    for kind in KINDS:
        jspec, tspec = _specs(kind, dim=16)
        jp = j_get_backend(kind).init(jax.random.PRNGKey(5), jspec)
        idx = _ids(9, seed=5)
        got = get_backend(kind).lookup(_carry(jp), tspec,
                                       torch.from_numpy(idx))
        want = np.asarray(j_get_backend(kind).lookup(
            jp, dataclasses.replace(jspec, use_kernel=True),
            jnp.asarray(idx)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_sign", (False, True))
def test_qrobe_lookup_adds_the_delta_term(use_sign):
    """A nonzero delta (mid-training state): the lookup adds
    delta[slot] · sign to the dequantized codes, exactly as JAX does."""
    jspec, tspec = _specs("qrobe")
    robe = dataclasses.replace(jspec.robe, use_sign=use_sign)
    jspec = dataclasses.replace(jspec, robe=robe)
    tspec = dataclasses.replace(
        tspec, robe=dataclasses.replace(tspec.robe, use_sign=use_sign))
    jp = j_get_backend("qrobe").init(jax.random.PRNGKey(2), jspec)
    rs = np.random.RandomState(2)
    jp = dict(jp, delta=jnp.asarray(rs.randn(2048).astype(np.float32) * 1e-3))
    idx = _ids(11, seed=2)
    tp = _carry(jp)
    got = get_backend("qrobe").lookup(tp, tspec, torch.from_numpy(idx))
    want = np.asarray(j_get_backend("qrobe").lookup(jp, jspec,
                                                    jnp.asarray(idx)))
    np.testing.assert_array_equal(got.numpy(), want)
    zero = get_backend("qrobe").lookup(dict(tp, delta=torch.zeros(2048)),
                                       tspec, torch.from_numpy(idx))
    assert not torch.equal(got, zero)


def test_qrobe_lookup_is_one_op_call(monkeypatch):
    """The delta term rides in the qrobe lookup's own op call: the backend
    makes one ``qrobe_lookup`` call (with ``delta``) and no ROBE lookup."""
    from repro_torch.kernels import ops as tops
    from repro_torch.nn.embedding_backends import qrobe as tqrobe

    def refuse(*args, **kwargs):
        raise AssertionError("the qrobe path ran robe_lookup")
    calls = []

    def counted(*args, **kwargs):
        calls.append(kwargs.get("delta"))
        return tops.qrobe_lookup(*args, **kwargs)
    monkeypatch.setattr(tops, "robe_lookup", refuse)
    monkeypatch.setattr(tqrobe, "qrobe_lookup", counted)
    assert not hasattr(tqrobe, "robe_lookup")
    jspec, tspec = _specs("qrobe")
    tp = _carry(j_get_backend("qrobe").init(jax.random.PRNGKey(3), jspec))
    out = get_backend("qrobe").lookup(tp, tspec,
                                      torch.from_numpy(_ids(7, seed=3)))
    assert out.shape == (7, len(VOCABS), tspec.dim)
    assert len(calls) == 1 and calls[0] is tp["delta"]


def test_lookup_bag_matches_jax():
    """The generic bag pooling over each new backend's lookup."""
    rs = np.random.RandomState(6)
    idx = rs.randint(0, min(VOCABS), (5, 3, 2)).astype(np.int32)
    idx[0, 0, 1] = -1
    idx[4, 2, :] = -1
    for kind in KINDS:
        jspec, tspec = _specs(kind)
        jp = j_get_backend(kind).init(jax.random.PRNGKey(6), jspec)
        got = get_backend(kind).lookup_bag(_carry(jp), tspec,
                                           torch.from_numpy(idx))
        want = j_get_backend(kind).lookup_bag(jp, jspec, jnp.asarray(idx))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


def test_params_from_numpy_keeps_int8_codes():
    jspec, _ = _specs("qrobe")
    tp = _carry(j_get_backend("qrobe").init(jax.random.PRNGKey(0), jspec))
    assert tp["codes"].dtype == torch.int8
    assert tp["scale"].dtype == tp["delta"].dtype == torch.float32


def test_qrobe_refuses_a_spec_without_robe():
    with pytest.raises(ValueError, match="robe spec required"):
        TSpec(vocab_sizes=VOCABS, dim=8, kind="qrobe")


# ---------------------------------------------------------------------------
# full: padded rows, and the hot-row-cache hook
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pad", (1, 7, 512))
def test_full_init_pads_rows_as_jax(pad):
    jspec, tspec = _specs("full")
    jp = j_get_backend("full").init(jax.random.PRNGKey(0), jspec,
                                    pad_rows_to=pad)
    tp = get_backend("full").init(torch.Generator().manual_seed(0), tspec,
                                  "cpu", pad_rows_to=pad)
    assert tuple(tp["table"].shape) == tuple(jp["table"].shape)
    assert tp["table"].shape[0] % pad == 0
    bound = 1.0 / np.sqrt(tspec.dim)
    assert float(tp["table"].abs().max()) <= bound


def test_full_params_of_init_params_load_leaf_for_leaf():
    """``init_params`` pads the full table to a multiple of 512 rows in both
    packages, so the JAX package's params carry over leaf for leaf."""
    jcfg = j_get_arch("dlrm-rm2").make_config("smoke", embedding="full")
    tcfg = t_get_arch("dlrm-rm2").make_config("smoke", embedding="full")
    jparams = jrec.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = trec.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    tleaves = jax.tree_util.tree_leaves_with_path(tparams)
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (_, a), (_, b) in zip(jleaves, tleaves):
        assert tuple(a.shape) == tuple(b.shape)
    rows = tparams["embedding"]["table"].shape[0]
    assert rows % 512 == 0 and rows >= sum(tcfg.vocab_sizes)


@pytest.mark.parametrize("field", (0, 1, 2))
def test_full_cacheable_rows_are_the_gathered_rows(field):
    jspec, tspec = _specs("full")
    jp = j_get_backend("full").init(jax.random.PRNGKey(4), jspec,
                                    pad_rows_to=512)
    tp = _carry(jp)
    idx = _ids(13, seed=field)
    ids = idx[:, field]
    got = get_backend("full").cacheable_rows(tp, tspec, field, ids)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    gathered = get_backend("full").lookup(tp, tspec, torch.from_numpy(idx))
    np.testing.assert_array_equal(got, gathered[:, field].numpy())
    np.testing.assert_array_equal(
        got, j_get_backend("full").cacheable_rows(jp, jspec, field, ids))


def test_full_lookup_is_differentiable_into_a_dense_grad():
    """The port's gather and autograd's scatter are full's lookup and
    backward: the gradient equals the JAX package's, padded rows zero."""
    jspec, tspec = _specs("full")
    jp = j_get_backend("full").init(jax.random.PRNGKey(2), jspec,
                                    pad_rows_to=512)
    idx = _ids(17, seed=9)
    ct = np.random.RandomState(9).randn(17, len(VOCABS), 8).astype(
        np.float32)
    want = jax.grad(lambda p: (j_get_backend("full").lookup(
        p, jspec, jnp.asarray(idx)) * jnp.asarray(ct)).sum())(jp)
    table = _carry(jp)["table"].requires_grad_(True)
    out = get_backend("full").lookup({"table": table}, tspec,
                                     torch.from_numpy(idx))
    (got,) = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), [table])
    np.testing.assert_allclose(got.numpy(), np.asarray(want["table"]),
                               rtol=1e-6, atol=1e-7)
    assert not got[sum(VOCABS):].any()

