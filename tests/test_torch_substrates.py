"""The registry-wide parity suite of ``tests/test_embedding_backends.py``
on the port, for every backend (``full``, ``robe``, ``qrobe``, ``hashed``,
``tt``), and the materialize oracles of ``kernels/ref.py`` against the JAX
package's.

Each substrate's lookup and gradient are held to an independent oracle:
the whole [total_rows, dim] table it represents, materialized by
``qr_materialize_ref`` / ``tt_materialize_ref`` / the core ROBE lookup,
then gathered (rtol 1e-5, atol 1e-6; gradients within 1e-4).  The two
oracles agree with the JAX package's on the same parameters (QR exactly:
one f32 product; TT within 1e-5: a three-way contraction in another
order).  Every test runs on the CPU: no kernel may be launched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.nn.embeddings import EmbeddingSpec as JSpec
from repro.nn.embeddings import embedding_init as j_embedding_init
from repro.core.robe import RobeSpec as JRobeSpec
from repro_torch import kernels as tk
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core.robe import RobeSpec, robe_lookup as robe_lookup_core
from repro_torch.kernels.ref import qr_materialize_ref, tt_materialize_ref
from repro_torch.models import recsys as trec
from repro_torch.nn.embedding_backends.qrobe import _expand
from repro_torch.nn.embeddings import (EmbeddingSpec, backend_names,
                                       embedding_init, embedding_lookup,
                                       embedding_lookup_bag, get_backend)

VOCABS = (40, 24, 64)
DIM = 8
BACKENDS = ("full", "robe", "hashed", "tt", "qrobe")


@pytest.fixture(autouse=True)
def _no_launches():
    tk.reset_launches()
    yield
    assert all(n == 0 for n in tk.launch_counts().values())


def _spec(kind: str, **kw) -> EmbeddingSpec:
    kw.setdefault("robe", RobeSpec(size=512, block_size=8, seed=3))
    kw.setdefault("hashed_buckets", 16)
    kw.setdefault("tt_rank", 4)
    return EmbeddingSpec(vocab_sizes=VOCABS, dim=DIM, kind=kind, **kw)


def _init(spec, seed: int = 0) -> dict:
    return embedding_init(torch.Generator().manual_seed(seed), spec, "cpu")


def _robe_table(memory, spec) -> torch.Tensor:
    rows = torch.arange(spec.total_rows)
    tids = torch.from_numpy(np.repeat(np.arange(spec.n_fields),
                                      np.asarray(spec.vocab_sizes)))
    local = rows - torch.from_numpy(spec.offsets)[tids]
    return robe_lookup_core(memory, spec.robe, tids, local, spec.dim)


def _reference_table(params: dict, spec) -> torch.Tensor:
    """The [total_rows, dim] logical table each substrate represents, by a
    path independent of the backend's per-row code."""
    if spec.kind == "full":
        return params["table"][:spec.total_rows]
    if spec.kind == "robe":
        return _robe_table(params["memory"], spec)
    if spec.kind == "hashed":
        return qr_materialize_ref(params["q_table"], params["r_table"],
                                  spec.vocab_sizes, spec.hashed_buckets)
    if spec.kind == "tt":
        return tt_materialize_ref(params["core0"], params["core1"],
                                  params["core2"])[:spec.total_rows]
    if spec.kind == "qrobe":
        size = params["codes"].shape[0]
        memory = (params["codes"].float() * _expand(params["scale"], size)
                  + params["delta"].float())
        return _robe_table(memory, spec)
    raise AssertionError(spec.kind)


def _global(spec, idx) -> torch.Tensor:
    return torch.from_numpy(spec.offsets)[None, :] + idx


def test_registry_returns_all_registered():
    for name in BACKENDS:
        assert get_backend(name).name == name
    assert set(backend_names()) == set(BACKENDS)


def test_unknown_backend_raises_with_names():
    with pytest.raises(KeyError, match="robe"):
        get_backend("no-such-substrate")


@pytest.mark.parametrize("kind", BACKENDS)
def test_lookup_matches_reference(kind):
    spec = _spec(kind)
    params = _init(spec)
    rs = np.random.RandomState(1)
    idx = torch.from_numpy(rs.randint(0, min(VOCABS), (16, 3)).astype(
        np.int32))
    got = embedding_lookup(params, spec, idx)
    want = _reference_table(params, spec)[_global(spec, idx)]
    assert got.shape == (16, 3, DIM)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", BACKENDS)
def test_grad_matches_reference(kind):
    spec = _spec(kind)
    params = _init(spec)
    rs = np.random.RandomState(2)
    idx = torch.from_numpy(rs.randint(0, min(VOCABS), (8, 3)).astype(
        np.int32))
    ct = torch.from_numpy(rs.randn(8, 3, DIM).astype(np.float32))
    names = sorted(k for k, v in params.items() if v.is_floating_point())

    def grads(fn):
        live = {k: (v.detach().requires_grad_(True) if k in names else v)
                for k, v in params.items()}
        return torch.autograd.grad((fn(live) * ct).sum(),
                                   [live[k] for k in names])

    gb = grads(lambda p: embedding_lookup(p, spec, idx))
    gr = grads(lambda p: _reference_table(p, spec)[_global(spec, idx)])
    for name, a, b in zip(names, gb, gr):
        assert float((a - b).abs().max()) < 1e-4, name


@pytest.mark.parametrize("kind", BACKENDS)
def test_field_subset_lookup(kind):
    spec = _spec(kind)
    params = _init(spec)
    rs = np.random.RandomState(3)
    idx_all = torch.from_numpy(rs.randint(0, min(VOCABS), (6, 3)).astype(
        np.int32))
    want = embedding_lookup(params, spec, idx_all)[:, 1:]
    got = embedding_lookup(params, spec, idx_all[:, 1:], fields=(1, 2))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", BACKENDS)
def test_lookup_bag_mean_with_weights(kind):
    """A weighted mean over a -1-padded bag equals the explicit weighted
    average of single lookups."""
    spec = _spec(kind)
    params = _init(spec)
    rs = np.random.RandomState(4)
    b, f, bag = 5, 3, 4
    idx = rs.randint(0, min(VOCABS), (b, f, bag))
    idx[0, 0, 2:] = -1                     # padded tail
    idx[2, 1, :] = -1                      # fully empty bag
    w = (rs.rand(b, f, bag) * 0.3).astype(np.float32)
    got = embedding_lookup_bag(params, spec,
                               torch.from_numpy(idx.astype(np.int32)),
                               combiner="mean", weights=torch.from_numpy(w))
    acc = np.zeros((b, f, DIM), np.float32)
    wm = np.zeros((b, f), np.float32)
    for j in range(bag):
        ej = embedding_lookup(params, spec, torch.from_numpy(
            np.maximum(idx[:, :, j], 0).astype(np.int32))).numpy()
        wj = w[:, :, j] * (idx[:, :, j] >= 0)
        acc += ej * wj[..., None]
        wm += wj
    want = np.where(wm[..., None] > 0,
                    acc / np.where(wm > 0, wm, 1.0)[..., None], 0.0)
    assert got.shape == (b, f, DIM)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_lookup_bag_sum_unweighted_masks_padding():
    spec = _spec("full")
    params = _init(spec)
    idx = torch.tensor([[[2, 5, -1]]], dtype=torch.int32).repeat(1, 3, 1)
    got = embedding_lookup_bag(params, spec, idx, combiner="sum")
    e = embedding_lookup(params, spec, torch.tensor([[2, 2, 2], [5, 5, 5]],
                                                    dtype=torch.int32))
    torch.testing.assert_close(got[0], e[0] + e[1], rtol=1e-6, atol=0)


def test_offsets_cached_and_correct():
    spec = _spec("full")
    assert spec.offsets is spec.offsets
    np.testing.assert_array_equal(spec.offsets, np.asarray([0, 40, 64]))


@pytest.mark.parametrize("bad", [(), (100, 0), (100, -3), (0,)])
def test_vocab_sizes_validated(bad):
    with pytest.raises(ValueError):
        EmbeddingSpec(vocab_sizes=bad, dim=8, kind="full")


@pytest.mark.parametrize("kind", BACKENDS)
def test_dlrm_config_sweeps_backend(kind):
    cfg = get_arch("dlrm-rm2").make_config("smoke", embedding=kind)
    rs = np.random.RandomState(0)
    batch = {"sparse": torch.from_numpy(rs.randint(
        0, 40, (8, cfg.n_fields)).astype(np.int32)),
        "dense": torch.from_numpy(rs.randn(8, cfg.n_dense).astype(
            np.float32)),
        "label": torch.from_numpy(rs.randint(0, 2, (8,)).astype(np.int32))}
    params = trec.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    flat = {k: v.requires_grad_(True)
            for k, v in params["embedding"].items() if v.is_floating_point()}
    loss = trec.loss_fn(dict(params, embedding=dict(params["embedding"],
                                                    **flat)), cfg, batch)[0]
    grads = torch.autograd.grad(loss, list(flat.values()))
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_fused_serve_default_none():
    for kind in ("full", "hashed", "tt", "qrobe"):
        assert get_backend(kind).fused_serve is None
    assert callable(get_backend("robe").fused_serve)


@pytest.mark.parametrize("kind", BACKENDS)
def test_cost_model_shape(kind):
    spec = _spec(kind)
    c = get_backend(kind).cost(spec, batch=1024)
    assert set(c) == {"params", "bytes_fetched", "flops"}
    assert c["params"] == spec.param_count > 0
    assert c["bytes_fetched"] > 0


def test_cacheable_rows_hooks():
    """``full`` and ``hashed`` serve the hot-row cache (hashed also widens
    a push's invalidation with ``affected_rows``); robe, qrobe and tt
    decline it."""
    for kind in ("full", "hashed"):
        assert callable(get_backend(kind).cacheable_rows)
    assert callable(get_backend("hashed").affected_rows)
    assert get_backend("full").affected_rows is None
    for kind in ("robe", "qrobe", "tt"):
        assert get_backend(kind).cacheable_rows is None


# ---------------------------------------------------------------------------
# the materialize oracles against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", (16, 7, 64))
def test_qr_materialize_matches_jax(m):
    jspec = JSpec(vocab_sizes=VOCABS, dim=DIM, kind="hashed",
                  hashed_buckets=m)
    jp = j_embedding_init(jax.random.PRNGKey(m), jspec)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    got = qr_materialize_ref(tp["q_table"], tp["r_table"], VOCABS, m)
    want = np.asarray(jref.qr_materialize_ref(jp["q_table"], jp["r_table"],
                                              VOCABS, m))
    assert tuple(got.shape) == want.shape == (sum(VOCABS), DIM)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rank", (4, 8))
@pytest.mark.parametrize("dim", (8, 24))
def test_tt_materialize_matches_jax(rank, dim):
    jspec = JSpec(vocab_sizes=VOCABS, dim=dim, kind="tt", tt_rank=rank,
                  robe=JRobeSpec(size=512, block_size=8))
    jp = j_embedding_init(jax.random.PRNGKey(rank), jspec)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    got = tt_materialize_ref(tp["core0"], tp["core1"], tp["core2"])
    want = np.asarray(jref.tt_materialize_ref(jp["core0"], jp["core1"],
                                              jp["core2"]))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_materialize_oracles_take_gradients():
    """Both oracles are autograd-able, with the JAX package's gradients."""
    jspec = JSpec(vocab_sizes=VOCABS, dim=DIM, kind="hashed",
                  hashed_buckets=16)
    jp = j_embedding_init(jax.random.PRNGKey(1), jspec)
    rs = np.random.RandomState(1)
    ct = rs.randn(sum(VOCABS), DIM).astype(np.float32)
    want = jax.grad(lambda q, r: (jref.qr_materialize_ref(
        q, r, VOCABS, 16) * jnp.asarray(ct)).sum(), argnums=(0, 1))(
        jp["q_table"], jp["r_table"])
    q, r = (torch.from_numpy(np.array(jp[k])).requires_grad_(True)
            for k in ("q_table", "r_table"))
    got = torch.autograd.grad((qr_materialize_ref(q, r, VOCABS, 16)
                               * torch.from_numpy(ct)).sum(), [q, r])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
