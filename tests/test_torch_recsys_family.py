"""The port's recsys family against the JAX package, on the CPU: AutoInt,
xDeepFM, the two-tower retrieval model, DeepFM, DCN and FiBiNET (and
DLRM beside them), at smoke sizes.

Parameters come from ``repro.models.recsys.init_params`` and are carried
into the port with ``convert.params_from_numpy``; batches are made with
numpy from a seed and fed to both packages.  Logits, ``loss_fn``'s loss,
every gradient leaf, the retrieval scores and each interaction must agree
within rtol = atol = 1e-5 in f32.  ``retrieval_batch`` must be equal to
the JAX one element for element.  On the CPU the port runs its plain
versions, so every kernel's ``launches`` count stays 0.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_arch_ids as j_all_arch_ids
from repro.configs import get_arch as j_get_arch
from repro.data.synthetic_ctr import CtrDataConfig as JCtrDataConfig
from repro.data.synthetic_ctr import retrieval_batch as j_retrieval_batch
from repro.kernels import ref as jref
from repro.models import recsys as jrec
from repro.nn import core as jcore
from repro.nn import interactions as jint
from repro_torch import kernels as tk
from repro_torch.configs import ARCH_IDS, all_arch_ids
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs.recsys_archs import (CRITEO_39, CRITEO_KAGGLE_VOCABS,
                                              TWO_TOWER_VOCABS)
from repro_torch.convert import params_from_numpy
from repro_torch.data import CtrDataConfig, retrieval_batch
from repro_torch.kernels.ref import cin_layer_ref
from repro_torch.models import recsys as trec
from repro_torch.nn import core as tcore
from repro_torch.nn import interactions as tint

TOL = dict(rtol=1e-5, atol=1e-5)
#: the JAX package's smoke cases: its registry's recsys bundles
#: (tests/test_archs.py's test_recsys_smoke) and the Table-3 families it
#: builds by hand (test_paper_extra_families_smoke)
BUNDLES = ("autoint", "dlrm-rm2", "two-tower-retrieval", "xdeepfm")
EXTRA = ("dcn", "deepfm", "fibinet")
#: each ported bundle's full config: (vocab layout, ROBE slots at 1000x)
FULL_SLOTS = {"autoint": (CRITEO_39, 540_214),
              "xdeepfm": (CRITEO_39, 337_634),
              "two-tower-retrieval": (TWO_TOWER_VOCABS, 28_726_016)}


def _extra_configs(arch: str, embedding: str = "robe"):
    """The JAX package's hand-built Table-3 smoke config of ``arch`` in
    both packages."""
    kw = dict(name=arch, vocab_sizes=(500, 300, 800, 100), embed_dim=8,
              embedding=embedding, robe_size=2048, robe_block=8)
    if arch == "dcn":
        kw.update(cross_layers=2, dnn=(16,))
    else:
        kw.update(dnn=(16,))
    return (jrec.RecsysConfig(arch=arch, **kw),
            trec.RecsysConfig(arch=arch, **kw))


def _configs(arch: str, embedding: str = "robe"):
    if arch in EXTRA:
        return _extra_configs(arch, embedding)
    return (j_get_arch(arch).make_config("smoke", embedding=embedding),
            t_get_arch(arch).make_config("smoke", embedding=embedding))


def _params(jcfg, seed: int = 0):
    jparams = jrec.init_params(jax.random.PRNGKey(seed), jcfg)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      "cpu")


def _batch(cfg, b: int = 8, seed: int = 0, high: int = 40) -> dict:
    rs = np.random.RandomState(seed)
    batch = {"sparse": rs.randint(0, high, (b, cfg.n_fields)).astype(np.int32),
             "label": rs.randint(0, 2, (b,)).astype(np.int32)}
    if cfg.n_dense:
        batch["dense"] = rs.randn(b, cfg.n_dense).astype(np.float32)
    return batch


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _float_leaves(tree) -> list:
    """(path, leaf) of every float leaf, in ``jax.tree``'s order."""
    return [(jax.tree_util.keystr(p), np.asarray(l))
            for p, l in jax.tree_util.tree_leaves_with_path(tree)
            if np.issubdtype(np.asarray(l).dtype, np.floating)]


def _port_grads(tparams, tcfg, tbatch):
    """loss and the gradient of every float leaf of the port's params, as
    a tree of numpy arrays (None at integer leaves)."""
    flat, treedef = jax.tree_util.tree_flatten(
        tparams, is_leaf=lambda x: isinstance(x, torch.Tensor))
    xs = [x.detach().requires_grad_(True) if x.is_floating_point() else x
          for x in flat]
    loss = trec.loss_fn(jax.tree_util.tree_unflatten(treedef, xs), tcfg,
                        tbatch)[0]
    live = [x for x in xs if x.is_floating_point()]
    gs = iter(torch.autograd.grad(loss, live))
    out = [next(gs).numpy() if x.is_floating_point() else None for x in xs]
    return float(loss.detach()), jax.tree_util.tree_unflatten(treedef, out)


def _assert_grads_match(jgrads, tgrads):
    want = _float_leaves(jgrads)
    got = dict(_float_leaves(jax.tree.map(
        lambda x: x, tgrads, is_leaf=lambda x: x is None)))
    assert [p for p, _ in want] == list(got), "gradient trees differ"
    for path, w in want:
        np.testing.assert_allclose(got[path], w, **TOL, err_msg=path)


# ---------------------------------------------------------------------------
# the six families (and DLRM) end to end: logits, loss, every gradient leaf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("embedding", ("full", "robe"))
@pytest.mark.parametrize("arch", BUNDLES + EXTRA)
def test_logits_loss_and_grads_match_jax(arch, embedding):
    jcfg, tcfg = _configs(arch, embedding)
    jparams, tparams = _params(jcfg)
    batch = _batch(jcfg, high=90 if arch in EXTRA else 40)
    tbatch = _torch(batch)
    tk.reset_launches()
    if jcfg.arch != "two_tower":
        want = np.asarray(jrec.forward(jparams, jcfg, batch))
        with torch.no_grad():
            got = trec.forward(tparams, tcfg, tbatch)
        assert got.shape == (8,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(
            trec.serve_scores(tparams, tcfg, tbatch).detach().numpy(),
            np.asarray(jrec.serve_scores(jparams, jcfg, batch)), **TOL)
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jrec.loss_fn(p, jcfg, batch), has_aux=True)(jparams)
    tloss, tgrads = _port_grads(tparams, tcfg, tbatch)
    assert np.isfinite(tloss)
    np.testing.assert_allclose(tloss, float(jloss), **TOL)
    _, taux = trec.loss_fn(tparams, tcfg, tbatch)
    assert set(taux) == set(jaux)
    _assert_grads_match(jgrads, tgrads)
    if embedding == "robe":
        assert float(np.abs(tgrads["embedding"]["memory"]).sum()) > 0
    assert sum(tk.launch_counts().values()) == 0      # CPU: plain versions


@pytest.mark.parametrize("embedding", ("full", "robe"))
@pytest.mark.parametrize("n_queries,n_cand", ((2, 64), (1, 300)))
def test_retrieval_scores_match_jax(embedding, n_queries, n_cand):
    jcfg, tcfg = _configs("two-tower-retrieval", embedding)
    jparams, tparams = _params(jcfg, seed=3)
    rs = np.random.RandomState(1)
    n_item = jcfg.n_fields - jcfg.n_user_fields
    batch = {"sparse": rs.randint(0, 40, (n_queries, jcfg.n_fields)
                                  ).astype(np.int32),
             "cand_sparse": rs.randint(0, 40, (n_cand, n_item)
                                       ).astype(np.int32)}
    want = np.asarray(jrec.serve_scores(jparams, jcfg, batch))
    with torch.inference_mode():
        got = trec.serve_scores(tparams, tcfg, _torch(batch))
    assert got.shape == (n_queries, n_cand) == want.shape
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("embedding", ("full", "robe"))
def test_tower_vectors_match_jax(embedding):
    jcfg, tcfg = _configs("two-tower-retrieval", embedding)
    jparams, tparams = _params(jcfg, seed=4)
    batch = _batch(jcfg, b=16, seed=6)
    ju, jv = jrec.tower_vectors(jparams, jcfg, batch)
    with torch.no_grad():
        tu, tv = trec.tower_vectors(tparams, tcfg, _torch(batch))
    for got, want in ((tu, ju), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(torch.linalg.norm(got, dim=-1).numpy(),
                                   1.0, **TOL)


@pytest.mark.parametrize("step,n_user,n_cand", ((0, 4, 1000), (7, 3, 17),
                                                (12, 4, 1)))
def test_retrieval_batch_matches_jax(step, n_user, n_cand):
    kw = dict(vocab_sizes=TWO_TOWER_VOCABS, batch_size=64, seed=9)
    want = j_retrieval_batch(JCtrDataConfig(**kw), step, n_user, n_cand)
    got = retrieval_batch(CtrDataConfig(**kw), step, n_user, n_cand)
    assert set(got) == set(want) == {"sparse", "cand_sparse"}
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    assert got["sparse"].shape == (1, len(TWO_TOWER_VOCABS))
    assert got["cand_sparse"].shape == (n_cand, len(TWO_TOWER_VOCABS)
                                        - n_user)
    assert (got["cand_sparse"] < np.asarray(TWO_TOWER_VOCABS[n_user:])).all()


# ---------------------------------------------------------------------------
# the compressed substrates under a non-DLRM arch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("embedding,arch", (("qrobe", "xdeepfm"),
                                            ("hashed", "autoint"),
                                            ("tt", "fibinet")))
def test_substrates_under_other_archs_match_jax(embedding, arch):
    jcfg, tcfg = _configs(arch, embedding)
    jparams, tparams = _params(jcfg, seed=1)
    batch = _batch(jcfg, b=12, seed=2, high=90 if arch in EXTRA else 40)
    tbatch = _torch(batch)
    with torch.no_grad():
        got = trec.forward(tparams, tcfg, tbatch)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jrec.forward(jparams, jcfg, batch)), **TOL)
    fl = [p for p in jax.tree.leaves(jparams)
          if jnp.issubdtype(p.dtype, jnp.floating)]
    # jax.grad over the float leaves alone (qrobe's int8 codes take none)
    treedef = jax.tree.structure(jparams)
    is_f = [jnp.issubdtype(p.dtype, jnp.floating)
            for p in jax.tree.leaves(jparams)]

    def jloss(floats):
        it = iter(floats)
        leaves = [next(it) if f else p
                  for f, p in zip(is_f, jax.tree.leaves(jparams))]
        return jrec.loss_fn(jax.tree.unflatten(treedef, leaves), jcfg,
                            batch)[0]
    loss, jg = jax.value_and_grad(jloss)(fl)
    it = iter(jg)
    jgrads = jax.tree.unflatten(treedef, [
        next(it) if f else p for f, p in zip(is_f, jax.tree.leaves(jparams))])
    tloss, tgrads = _port_grads(tparams, tcfg, tbatch)
    np.testing.assert_allclose(tloss, float(loss), **TOL)
    _assert_grads_match(jgrads, tgrads)
    project = trec.make_project_fn(tcfg)
    assert (project is None) == (embedding != "qrobe")


# ---------------------------------------------------------------------------
# the interactions, one by one
# ---------------------------------------------------------------------------

def _chunk_of(monkeypatch, chunk, *widths):
    """Set the CIN's budget to ``chunk`` samples of z at ``widths`` (f0,
    fk, d) in f32; None keeps the default (one chunk at these sizes)."""
    if chunk is not None:
        monkeypatch.setattr(tint, "CIN_CHUNK_BYTES",
                            chunk * int(np.prod(widths)) * 4)


@pytest.mark.parametrize("b,f0,fk,h,d,chunk", (
    (7, 6, 5, 4, 8, 3), (9, 39, 39, 20, 10, 4), (5, 4, 16, 16, 3, 1),
    (6, 3, 2, 5, 4, None)))
def test_chunked_cin_matches_the_oracle(monkeypatch, b, f0, fk, h, d, chunk):
    _chunk_of(monkeypatch, chunk, f0, fk, d)
    assert tint.cin_chunk(f0, fk, d, 4) == (chunk or tint.cin_chunk(
        f0, fk, d, 4))
    rs = np.random.RandomState(3)
    x0, xk = rs.randn(b, f0, d), rs.randn(b, fk, d)
    w = rs.randn(h, f0, fk) * 0.01          # cin_init's scale
    t = [torch.from_numpy(a.astype(np.float32)) for a in (x0, xk, w)]
    want = np.asarray(jref.cin_layer_ref(*(jnp.asarray(a, jnp.float32)
                                           for a in (x0, xk, w))))
    ref = cin_layer_ref(*t)
    np.testing.assert_allclose(ref.numpy(), want, rtol=1e-4, atol=1e-5)
    got = tint.cin_layer(*t)
    assert got.shape == (b, h, d)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-5)
    # the oracle against the explicit z contraction
    z = np.einsum("bid,bjd->bijd", x0, xk)
    np.testing.assert_allclose(ref.numpy(), np.einsum("hij,bijd->bhd", w, z),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("chunk", (1, 3, None))
def test_chunked_cin_apply_and_its_gradient_match_jax(monkeypatch, chunk):
    # layer 1 is 6 x 6 fields wide, layer 2 6 x 5: at most `chunk` samples
    _chunk_of(monkeypatch, chunk, 6, 6, 4)
    rs = np.random.RandomState(5)
    x0 = rs.randn(7, 6, 4).astype(np.float32)
    jp = jint.cin_init(jax.random.PRNGKey(2), 6, (5, 3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    g = rs.randn(7, 8).astype(np.float32)

    def jfn(p, x):
        return (jint.cin_apply(p, x) * g).sum()
    jv, (jgp, jgx) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jp, jnp.asarray(x0))
    tx = torch.from_numpy(x0).requires_grad_(True)
    ws = [l["w"].requires_grad_(True) for l in tp]
    out = tint.cin_apply(tp, tx)
    assert out.shape == (7, 8)
    tv = (out * torch.from_numpy(g)).sum()
    grads = torch.autograd.grad(tv, [tx] + ws)
    np.testing.assert_allclose(float(tv.detach()), float(jv), **TOL)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), **TOL)
    for got, want in zip(grads[1:], jgp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want["w"]), **TOL)


def test_cin_chunk_budget():
    # xDeepFM's widest layer: 39 x 200 x 10 f32 is 312 KB a sample
    assert tint.cin_chunk(39, 200, 10, 4) == 6410
    assert tint.cin_chunk(39, 200, 10, 4) * 39 * 200 * 10 * 4 \
        <= tint.CIN_CHUNK_BYTES
    assert tint.cin_chunk(10 ** 5, 10 ** 5, 10 ** 3, 4) == 1


@pytest.mark.parametrize("f", (1, 2, 3, 6, 39))
def test_bilinear_pair_order(f):
    i, j = torch.tril_indices(f, f, offset=-1)
    ji, jj = jnp.tril_indices(f, k=-1)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(j.numpy(), np.asarray(jj))
    rs = np.random.RandomState(f)
    feats = rs.randn(3, f, 5).astype(np.float32)
    jp = jint.bilinear_init(jax.random.PRNGKey(f), f, 5)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    got = tint.bilinear_apply(tp, torch.from_numpy(feats))
    want = np.asarray(jint.bilinear_apply(jp, jnp.asarray(feats)))
    assert got.shape == want.shape == (3, f * (f - 1) // 2 * 5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _interaction_case(name, rs):
    """(JAX params, JAX fn, port fn, input [B, F, D]) of one interaction."""
    x = rs.randn(5, 6, 8).astype(np.float32)
    key = jax.random.PRNGKey(11)
    if name == "fm":
        return None, lambda p, v: jint.fm_interaction(v), \
            lambda p, v: tint.fm_interaction(v), x
    if name == "cross_net":
        jp = jint.cross_net_init(key, 48, 3)
        return jp, lambda p, v: jint.cross_net_apply(p, v.reshape(5, -1)), \
            lambda p, v: tint.cross_net_apply(p, v.reshape(5, -1)), x
    if name == "senet":
        jp = jint.senet_init(key, 6)
        return jp, jint.senet_apply, tint.senet_apply, x
    if name == "autoint":
        jp = jint.autoint_layer_init(key, 8, 4, 3)
        return jp, lambda p, v: jint.autoint_layer_apply(p, v, 3), \
            lambda p, v: tint.autoint_layer_apply(p, v, 3), x
    raise AssertionError(name)


@pytest.mark.parametrize("name", ("fm", "cross_net", "senet", "autoint"))
def test_interactions_and_their_gradients_match_jax(name):
    rs = np.random.RandomState(7)
    jp, jfn, tfn, x = _interaction_case(name, rs)
    tp = None if jp is None else params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")
    want = np.asarray(jfn(jp, jnp.asarray(x)))
    g = rs.randn(*want.shape).astype(np.float32)
    jgx = jax.grad(lambda v: (jfn(jp, v) * g).sum())(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tfn(tp, tx)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    (tgx,) = torch.autograd.grad((got * torch.from_numpy(g)).sum(), [tx])
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), **TOL)


# ---------------------------------------------------------------------------
# inits, configs and the registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", BUNDLES + EXTRA)
def test_init_params_tree_matches_jax(arch):
    """Same keys, shapes and dtypes leaf by leaf; draws are seeded."""
    jcfg, tcfg = _configs(arch)
    jleaves = jax.tree_util.tree_leaves_with_path(
        jrec.init_params(jax.random.PRNGKey(0), jcfg))
    tparams = trec.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tleaves = jax.tree_util.tree_leaves_with_path(tparams)
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (_, a), (_, b) in zip(jleaves, tleaves):
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.float32
    again = trec.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    for (_, a), (_, b) in zip(tleaves, jax.tree_util.tree_leaves_with_path(
            again)):
        assert torch.equal(a, b)


def test_scaled_inits_are_normal_times_scale():
    """dense_init(scale=s) draws normal × s (the cross net's and the CIN's
    0.01 inits); without a scale it stays He-uniform."""
    gen = torch.Generator().manual_seed(0)
    w = tcore.dense_init(gen, 400, 300, "cpu", scale=0.01)["w"]
    assert abs(float(w.std()) - 0.01) < 2e-4 and abs(float(w.mean())) < 1e-4
    jw = np.asarray(jcore.dense_init(jax.random.PRNGKey(0), 400, 300,
                                     scale=0.01)["w"])
    assert abs(float(jw.std()) - 0.01) < 2e-4
    u = tcore.dense_init(gen, 400, 300, "cpu")["w"]
    lim = float(np.sqrt(6.0 / 400))
    assert float(u.abs().max()) <= lim and float(u.abs().max()) > 0.9 * lim
    n = tcore.normal_init(gen, (1000, 100), "cpu")
    assert abs(float(n.std()) - 0.02) < 4e-4
    cin = tint.cin_init(gen, 39, (200, 200), "cpu")
    assert [tuple(l["w"].shape) for l in cin] == [(200, 39, 39),
                                                  (200, 39, 200)]
    assert abs(float(cin[1]["w"].std()) - 0.01) < 2e-4
    cross = tint.cross_net_init(gen, 64, 2, "cpu")
    assert all(set(l) == {"w", "b"} and not l["b"].any() for l in cross)


@pytest.mark.parametrize("arch", ("autoint", "two-tower-retrieval",
                                  "xdeepfm"))
@pytest.mark.parametrize("variant", ("full", "smoke"))
def test_bundles_match_jax(arch, variant):
    jcfg = j_get_arch(arch).make_config(variant)
    tcfg = t_get_arch(arch).make_config(variant)
    for field in dataclasses.fields(tcfg):
        if field.name != "compute_dtype":
            assert getattr(tcfg, field.name) == getattr(jcfg, field.name), \
                field.name
    assert t_get_arch(arch).shapes == j_get_arch(arch).shapes
    assert t_get_arch(arch).notes == j_get_arch(arch).notes
    jspec, tspec = jcfg.embedding_spec(), tcfg.embedding_spec()
    assert tspec.robe == type(tspec.robe)(**dataclasses.asdict(jspec.robe))
    assert tspec.compression == pytest.approx(jspec.compression)
    if variant == "full":
        vocabs, slots = FULL_SLOTS[arch]
        assert tcfg.vocab_sizes == vocabs and tcfg.robe_size == slots \
            == jcfg.robe_size


def test_vocab_layouts_and_registry_match_jax():
    from repro.configs import recsys_archs as jra
    # the JAX registry loads its bundle modules only while it is empty:
    # register the LM and GNN bundles too, whatever ran before
    from repro.configs import gnn_archs, lm_archs  # noqa: F401
    assert CRITEO_KAGGLE_VOCABS == jra.CRITEO_KAGGLE_VOCABS
    assert CRITEO_39 == jra.CRITEO_39 and len(CRITEO_39) == 39
    assert TWO_TOWER_VOCABS == jra.TWO_TOWER_VOCABS
    recsys = tuple(a for a in j_all_arch_ids()
                   if j_get_arch(a).kind == "recsys")
    assert all_arch_ids() == j_all_arch_ids()
    assert tuple(a for a in ARCH_IDS if t_get_arch(a).kind == "recsys") \
        == recsys + ("dlrm-criteo-tb",)
    # registering the new bundles leaves the DLRM ones as they were
    assert t_get_arch("dlrm-criteo-tb").make_config("full").robe_size \
        == 26_135_627
    assert t_get_arch("dlrm-rm2").make_config("full").arch == "dlrm"


def test_unknown_arch_raises_as_jax_does():
    jcfg, tcfg = _configs("dlrm-rm2")
    jbad = dataclasses.replace(jcfg, arch="bogus")
    tbad = dataclasses.replace(tcfg, arch="bogus")
    with pytest.raises(ValueError, match="unknown recsys arch bogus"):
        jrec.init_params(jax.random.PRNGKey(0), jbad)
    with pytest.raises(ValueError, match="unknown recsys arch bogus"):
        trec.init_params(tbad, torch.Generator(), "cpu")
    jparams, tparams = _params(jcfg)
    batch = _batch(jcfg)
    with pytest.raises(ValueError, match="forward undefined for bogus"):
        jrec.loss_fn(jparams, jbad, batch)
    with pytest.raises(ValueError, match="forward undefined for bogus"):
        trec.loss_fn(tparams, tbad, _torch(batch))
