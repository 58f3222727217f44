"""The port's DLRM serve path against the JAX package's, end to end.

Parameters come from ``repro.models.recsys.init_params`` and are carried
into the port with ``convert.params_from_numpy`` (the two frameworks' random
streams differ), so both packages score the same model on the same
batches.  Scores must agree within rtol = atol = 1e-5 in f32, for each
ported substrate (full, robe, qrobe, hashed, tt) and on both serve paths
(``use_kernel`` True: the fused serve op where the substrate has one;
False: lookup -> concat -> dot interaction), on the CPU where the port runs
its plain versions.  The configs, the data streams and the server's ``n_valid``
slicing are checked against the JAX package too.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.data.synthetic_ctr import CtrDataConfig as JCtrDataConfig
from repro.data.synthetic_ctr import CtrStream as JCtrStream
from repro.data.synthetic_ctr import RequestStream as JRequestStream
from repro.models import recsys as jrec
from repro.nn.embeddings import get_backend as j_get_backend
from repro.serve.server import EmbeddingServer as JServer
from repro.serve.server import ServerConfig as JServerConfig
from repro_torch import kernels as tk
from repro_torch.configs.recsys_archs import CRITEO_TB_VOCABS
from repro_torch.configs.registry import get_arch as t_get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.data import CtrDataConfig, CtrStream, RequestStream
from repro_torch.models import recsys as trec
from repro_torch.nn.embeddings import EmbeddingSpec, get_backend
from repro_torch.serve.server import EmbeddingServer, ServerConfig

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("dlrm-rm2", "dlrm-criteo-tb")
EMBEDDINGS = ("full", "robe", "qrobe", "hashed", "tt")


def _configs(arch: str, use_kernel: bool, embedding: str = "robe"):
    jcfg = j_get_arch(arch).make_config("smoke", embedding=embedding,
                                        use_kernel=use_kernel)
    tcfg = t_get_arch(arch).make_config("smoke", embedding=embedding,
                                        use_kernel=use_kernel)
    return jcfg, tcfg


def _batch(cfg, b: int, seed: int) -> dict:
    stream = JCtrStream(JCtrDataConfig(vocab_sizes=cfg.vocab_sizes,
                                       n_dense=cfg.n_dense, batch_size=b,
                                       seed=seed))
    return stream.batch_at(3)


def _to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(batch[k]) for k in ("dense", "sparse")}


@pytest.mark.parametrize("embedding", EMBEDDINGS)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_kernel", (False, True), ids=("unfused", "fused"))
@pytest.mark.parametrize("b", (16, 13))
def test_serve_scores_match_jax(embedding, arch, use_kernel, b):
    jcfg, tcfg = _configs(arch, use_kernel, embedding)
    jparams = jrec.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    batch = _batch(jcfg, b, seed=5)
    want = np.asarray(jrec.serve_scores(
        jparams, jcfg, {k: batch[k] for k in ("dense", "sparse")}))
    tk.reset_launches()
    with torch.inference_mode():
        got = trec.serve_scores(tparams, tcfg, _to_torch(batch))
    assert got.shape == (b,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert sum(tk.launch_counts().values()) == 0      # CPU: plain versions


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_and_unfused_paths_agree(arch):
    _, tcfg = _configs(arch, True)
    jcfg = j_get_arch(arch).make_config("smoke")
    tparams = params_from_numpy(jax.tree.map(
        np.asarray, jrec.init_params(jax.random.PRNGKey(1), jcfg)), "cpu")
    tb = _to_torch(_batch(jcfg, 11, seed=2))
    with torch.inference_mode():
        fused = trec.serve_scores(tparams, tcfg, tb)
        unfused = trec.serve_scores(
            tparams, dataclasses.replace(tcfg, use_kernel=False), tb)
    np.testing.assert_allclose(fused.numpy(), unfused.numpy(), **TOL)


def test_emb_key_bypasses_the_lookup():
    jcfg, tcfg = _configs("dlrm-rm2", True)
    tparams = params_from_numpy(jax.tree.map(
        np.asarray, jrec.init_params(jax.random.PRNGKey(2), jcfg)), "cpu")
    tb = _to_torch(_batch(jcfg, 8, seed=3))
    with torch.inference_mode():
        emb = trec._embed(tparams, tcfg, tb["sparse"])
        direct = trec.serve_scores(tparams, tcfg, tb)
        cached = trec.serve_scores(tparams, tcfg,
                                   {"dense": tb["dense"], "emb": emb})
    np.testing.assert_allclose(cached.numpy(), direct.numpy(), **TOL)


@pytest.mark.parametrize("embedding", EMBEDDINGS)
def test_server_scores_match_jax_and_slice_to_n_valid(embedding):
    kw = dict(vocab_sizes=(1000, 500, 2000, 100, 50, 300), embed_dim=16,
              n_dense=13, bot_mlp=(64, 16), top_mlp=(32, 1),
              backends=(embedding,), robe_compression=10, robe_block=16,
              cache_capacity=0)
    for use_kernel in (False, True):
        jsrv = JServer(JServerConfig(use_kernel=use_kernel, **kw))
        params = params_from_numpy(
            {embedding: jax.tree.map(np.asarray, jsrv.params(embedding))},
            "cpu")
        tsrv = EmbeddingServer(ServerConfig(use_kernel=use_kernel, **kw),
                               params=params, device="cpu")
        assert tsrv.recsys_config(embedding) == dataclasses.replace(
            tsrv.recsys_config(embedding),
            **{f.name: getattr(jsrv.recsys_config(embedding), f.name)
               for f in dataclasses.fields(tsrv.recsys_config(embedding))
               if f.name != "compute_dtype"})
        batch = _batch(tsrv.recsys_config(embedding), 32, seed=4)
        batch = {k: batch[k] for k in ("dense", "sparse")}
        tk.reset_launches()
        got = tsrv.score(embedding, batch, n_valid=21)
        want = jsrv.score(embedding, batch, n_valid=21)
        assert got.shape == (21,)
        np.testing.assert_allclose(got, want, **TOL)
        fn = tsrv.score_fn(embedding)
        np.testing.assert_array_equal(fn(batch, n_valid=21), got)
        assert tsrv.score(embedding, batch).shape == (32,)
        assert sum(tk.launch_counts().values()) == 0  # CPU: plain versions


def test_server_refuses_what_is_not_ported():
    kw = dict(vocab_sizes=(100, 50), embed_dim=8, cache_capacity=0)
    # full serves now, and the default backends are the JAX package's
    srv = EmbeddingServer(ServerConfig(**kw), device="cpu")
    assert srv.backends == JServerConfig(vocab_sizes=(100, 50)).backends \
        == ("full", "robe", "hashed", "tt")
    batch = _batch(srv.recsys_config("full"), 4, seed=1)
    assert srv.score("full", {k: batch[k] for k in ("dense", "sparse")}
                     ).shape == (4,)
    with pytest.raises(KeyError, match="unknown embedding backend"):
        EmbeddingServer(ServerConfig(backends=("dense",), **kw),
                        device="cpu")
    assert get_backend("robe").cacheable_rows is None   # robe declines it
    spec = srv.recsys_config("full").embedding_spec()
    # the row-sharded layout and lookup are ported: outside a mesh the
    # distributed lookup is the local one, and the layout is JAX's
    from repro.dist.api import default_rules as j_default_rules
    from repro_torch.dist.api import default_rules
    ids = torch.from_numpy(batch["sparse"])
    emb = srv.params("full")["embedding"]
    assert torch.equal(get_backend("full").lookup_dist(emb, spec, ids),
                       get_backend("full").lookup(emb, spec, ids))
    jspec = dataclasses.replace(
        srv.recsys_config("full"), compute_dtype=None)
    assert tuple(get_backend("full").param_specs(
        spec, default_rules())["table"]) == tuple(
        j_get_backend("full").param_specs(jrec.RecsysConfig(
            **{f.name: getattr(jspec, f.name)
               for f in dataclasses.fields(jspec)
               if f.name != "compute_dtype"}).embedding_spec(),
            j_default_rules())["table"]) == ("model", None)
    # push and warm_caches are ported (the serving tier): a push needs a
    # publish dir, and warming a server without caches does nothing
    with pytest.raises(ValueError, match="model_dir"):
        srv.push("robe")
    srv.warm_caches([batch["sparse"]])
    assert all(srv.cache(b) is None for b in srv.backends)
    # every recsys arch of the JAX package inits; an unknown one raises as
    # the JAX package's init does
    autoint = dataclasses.replace(srv.recsys_config("robe"), arch="autoint",
                                  attn_layers=1, attn_dim=4, attn_heads=2)
    assert set(trec.init_params(autoint, torch.Generator(), "cpu")) == {
        "embedding", "attn", "out"}
    bogus = dataclasses.replace(srv.recsys_config("robe"), arch="bogus")
    with pytest.raises(ValueError, match="unknown recsys arch bogus"):
        jrec.init_params(jax.random.PRNGKey(0), bogus)
    with pytest.raises(ValueError, match="unknown recsys arch bogus"):
        trec.init_params(bogus, torch.Generator(), "cpu")


def test_entry_points_run_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ServerConfig(vocab_sizes=(100, 50), embed_dim=8, cache_capacity=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EmbeddingServer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"w": np.zeros(3, np.float32)})


def test_init_params_tree_matches_jax():
    """Same keys, shapes and dtypes leaf by leaf; draws are seeded."""
    jcfg, tcfg = _configs("dlrm-criteo-tb", False)
    jleaves = jax.tree_util.tree_leaves_with_path(
        jrec.init_params(jax.random.PRNGKey(0), jcfg))
    gen = torch.Generator().manual_seed(0)
    tparams = trec.init_params(tcfg, gen, "cpu")
    tleaves = jax.tree_util.tree_leaves_with_path(tparams)
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (_, a), (_, b) in zip(jleaves, tleaves):
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.float32
    again = trec.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["embedding"]["memory"],
                       tparams["embedding"]["memory"])
    assert torch.equal(again["top"][0]["w"], tparams["top"][0]["w"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("variant", ("full", "smoke"))
def test_configs_match_jax(arch, variant):
    jcfg = j_get_arch(arch).make_config(variant)
    tcfg = t_get_arch(arch).make_config(variant)
    for field in dataclasses.fields(tcfg):
        if field.name != "compute_dtype":
            assert getattr(tcfg, field.name) == getattr(jcfg, field.name), \
                field.name
    assert tcfg.compute_dtype == torch.float32
    assert t_get_arch(arch).shapes == j_get_arch(arch).shapes
    jspec, tspec = jcfg.embedding_spec(), tcfg.embedding_spec()
    assert tspec.robe == type(tspec.robe)(**dataclasses.asdict(jspec.robe))
    assert tspec.compression == pytest.approx(jspec.compression)
    assert (tspec.offsets == jspec.offsets).all()
    assert get_backend("robe").cost(tspec, 512) == \
        j_get_backend("robe").cost(jspec, 512)


def test_paper_model_array_size():
    cfg = t_get_arch("dlrm-criteo-tb").make_config("full")
    assert cfg.robe_size == 26_135_627
    assert sum(CRITEO_TB_VOCABS) == 204_184_588
    srv = ServerConfig(vocab_sizes=CRITEO_TB_VOCABS, embed_dim=128,
                       n_dense=13, bot_mlp=(512, 256, 128),
                       top_mlp=(1024, 1024, 512, 256, 1), robe_block=32)
    assert srv.recsys_cfg("robe").robe_size == 26_135_627


def test_embedding_spec_validation():
    from repro_torch.core.robe import RobeSpec
    robe = RobeSpec(size=4096, block_size=8)
    for bad in (dict(vocab_sizes=()), dict(vocab_sizes=(3, 0)),
                dict(vocab_sizes=(3,), dim=0),
                dict(vocab_sizes=(3,), robe=None)):
        kw = dict(dim=8, robe=robe)
        kw.update(bad)
        with pytest.raises(ValueError):
            EmbeddingSpec(**kw)
    # the ZeRO-3 placement is ported: it builds, and the fused serve
    # kernel declines it (the array is sharded over model)
    z3 = EmbeddingSpec(vocab_sizes=(3,), dim=8, robe=robe, placement="model")
    assert get_backend("robe").fused_serve({}, z3, None, None) is None


@pytest.mark.parametrize("drift_period,multi_hot", [(0, 0), (3, 2)])
def test_streams_match_jax(drift_period, multi_hot):
    kw = dict(vocab_sizes=CRITEO_TB_VOCABS, n_dense=13, batch_size=64,
              seed=9, multi_hot=multi_hot, drift_period=drift_period)
    js, ts = JCtrStream(JCtrDataConfig(**kw)), CtrStream(CtrDataConfig(**kw))
    for step in (0, 4, 7):
        a, b = js.batch_at(step), ts.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    jr, tr = JRequestStream(JCtrDataConfig(**kw)), \
        RequestStream(CtrDataConfig(**kw))
    for i in (0, 63, 64, 200):
        a, b = jr.request_at(i), tr.request_at(i)
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k
