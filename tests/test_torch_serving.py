"""The port's serving tier against the JAX package's, on the CPU.

* the router (``DeadlineBatcher``, ``FixedBatcher``, ``stack_and_pad``,
  ``AsyncRouter``, ``MicroBatcher``), ``percentile`` and
  ``poisson_arrivals``: the same decisions and values, exactly, on
  random traces (hypothesis);
* the hot-row cache: ``CountMinSketch``'s table, ``full``'s and
  ``hashed``'s ``cacheable_rows`` and ``hashed.affected_rows`` equal to
  the JAX hooks'; after the same zipf traffic the same resident rows,
  hits and misses;
* the server: cache-on scores equal cache-off scores bit for bit, and the
  JAX server's within 1e-5;
* the replay and the fleet under ``synthetic_service`` (push walls from
  the same fake clock in both packages): ``ReplayReport``s equal field
  for field, single server, with push events, at ``n_replicas=4`` and
  for staggered and synchronized rollouts; the fleet's admission order
  and retry-on-shed.

Every test runs on the CPU: no kernel may be launched.
"""

import asyncio
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.data import synthetic_ctr as jdata
from repro.nn.embeddings import EmbeddingSpec as JSpec
from repro.nn.embeddings import embedding_init as j_embedding_init
from repro.nn.embeddings import get_backend as j_get_backend
from repro.serve import fleet as jfleet
from repro.serve import hot_cache as jcache
from repro.serve import replay as jreplay
from repro.serve import router as jrouter
from repro.serve import server as jserver
from repro.serve import serving as jserving
from repro_torch import kernels as tk
from repro_torch.convert import params_from_numpy
from repro_torch.data import synthetic_ctr as tdata
from repro_torch.nn.embeddings import EmbeddingSpec as TSpec
from repro_torch.nn.embeddings import get_backend as t_get_backend
from repro_torch.serve import fleet as tfleet
from repro_torch.serve import hot_cache as tcache
from repro_torch.serve import replay as treplay
from repro_torch.serve import router as trouter
from repro_torch.serve import server as tserver
from repro_torch.serve import serving as tserving

VOCABS = (12_000, 6_000, 18_000, 4_000)


@pytest.fixture(autouse=True)
def _no_launches():
    tk.reset_launches()
    yield
    assert all(n == 0 for n in tk.launch_counts().values())


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_params(jparams):
    return params_from_numpy(_np(jparams), "cpu")


def _server_cfgs(**kw):
    kw = dict(dict(vocab_sizes=VOCABS, embed_dim=8, n_dense=4,
                   bot_mlp=(16, 8), top_mlp=(16, 1), robe_compression=100,
                   cache_capacity=16384), **kw)
    return jserver.ServerConfig(**kw), tserver.ServerConfig(**kw)


def _server_batch(n=16, step=0, vocabs=VOCABS):
    b = jdata.CtrStream(jdata.CtrDataConfig(vocab_sizes=vocabs, n_dense=4,
                                            batch_size=n)).batch_at(step)
    return {"dense": b["dense"], "sparse": b["sparse"]}


def _mini_requests(n, seed=0):
    return jdata.RequestStream(jdata.CtrDataConfig(
        vocab_sizes=VOCABS, n_dense=4, batch_size=64, seed=seed)).requests(n)


class _FakeTime:
    """``time.perf_counter`` stepping a fixed 0.5 ms a call: the push walls
    the replay measures are then the same in both packages."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 5e-4
        return self.t


@pytest.fixture
def fake_clocks(monkeypatch):
    for mod in (jreplay, treplay):
        monkeypatch.setattr(mod, "time", _FakeTime())


# ---------------------------------------------------------------------------
# percentile, arrivals, request stream
# ---------------------------------------------------------------------------

@settings(max_examples=30, deadline=None)
@given(vals=st.lists(st.floats(-1e3, 1e3), min_size=1, max_size=40),
       p=st.floats(1e-6, 1.0))
def test_percentile_exact(vals, p):
    s = np.sort(np.asarray(vals))
    assert tserving.percentile(s, p) == jserving.percentile(s, p)


def test_percentile_known_vector_and_errors():
    lats = np.asarray([10.0, 20.0, 30.0, 40.0])
    got = [tserving.percentile(lats, p) for p in (0.25, 0.5, 0.75, 0.99, 1)]
    assert got == [10.0, 20.0, 30.0, 40.0, 40.0]
    for bad in ((np.asarray([]), 0.5), (lats, 0.0), (lats, 1.5)):
        with pytest.raises(ValueError):
            tserving.percentile(*bad)


@pytest.mark.parametrize("rate,n,seed", [(1000.0, 4096, 5), (2000.0, 64, 0),
                                         (3.5, 7, 2 ** 31 + 3)])
def test_poisson_arrivals_same_floats(rate, n, seed):
    np.testing.assert_array_equal(tdata.poisson_arrivals(rate, n, seed),
                                  jdata.poisson_arrivals(rate, n, seed))
    with pytest.raises(ValueError):
        tdata.poisson_arrivals(0.0, 8)


def test_request_stream_id_batches_equal():
    cfg = dict(vocab_sizes=VOCABS, n_dense=4, batch_size=8,
               drift_period=3)
    t = tdata.RequestStream(tdata.CtrDataConfig(**cfg))
    j = jdata.RequestStream(jdata.CtrDataConfig(**cfg))
    for a, b in zip(t.id_batches(5, start_step=2), j.id_batches(5, 2)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t.requests(20), j.requests(20)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# the batching policy on random traces
# ---------------------------------------------------------------------------

_ops = st.lists(st.one_of(
    st.tuples(st.just("admit"), st.floats(0, 0.01),
              st.one_of(st.none(), st.floats(-0.002, 0.05))),
    st.tuples(st.just("poll"), st.floats(0, 0.02)),
    st.tuples(st.just("observe"), st.floats(1e-4, 0.02)),
    st.tuples(st.just("drain"))), max_size=60)


def _drive(mod, cls, cfg_kw, ops):
    b = getattr(mod, cls)(mod.RouterConfig(**cfg_kw))
    now, out = 0.0, []
    for op in ops:
        if op[0] == "admit":
            now += op[1]
            dl = None if op[2] is None else now + op[2]
            try:
                out.append(("ok", b.admit({"x": np.float32([len(out)])},
                                          now, deadline=dl).seq))
            except mod.LoadShedError as e:
                out.append(("shed", e.reason, str(e)))
        elif op[0] == "poll":
            now += op[1]
            got = b.poll(now)
            out.append(None if got is None else [r.seq for r in got])
        elif op[0] == "observe":
            b.observe(op[1])
        else:
            out.append([[r.seq for r in c] for c in b.drain()])
        out.append((b.close_at(), b.service_estimate, len(b), b.shed_count))
    return out


@settings(max_examples=40, deadline=None)
@given(cls=st.sampled_from(["DeadlineBatcher", "FixedBatcher"]),
       max_batch=st.integers(1, 8), max_queue=st.integers(1, 16),
       max_wait=st.floats(1e-4, 0.05), margin=st.floats(0, 0.003),
       init=st.floats(1e-4, 0.01), window=st.integers(1, 8),
       shed=st.booleans(), ops=_ops)
def test_batchers_same_decisions(cls, max_batch, max_queue, max_wait, margin,
                                 init, window, shed, ops):
    kw = dict(max_batch=max_batch, max_queue=max_queue, max_wait_s=max_wait,
              close_margin_s=margin, init_service_s=init,
              service_window=window, shed_infeasible=shed)
    assert _drive(trouter, cls, kw, ops) == _drive(jrouter, cls, kw, ops)


def test_deadline_batcher_known_closeouts():
    b = trouter.DeadlineBatcher(trouter.RouterConfig(
        max_batch=4, init_service_s=0.002, close_margin_s=0.001))
    b.admit({"x": np.float32([0])}, now=0.0, deadline=0.100)
    b.admit({"x": np.float32([1])}, now=0.001, deadline=0.020)
    assert b.close_at() == pytest.approx(0.017)
    assert b.poll(now=0.010) is None and len(b.poll(now=0.017)) == 2
    f = trouter.FixedBatcher(trouter.RouterConfig(max_batch=4,
                                                  max_wait_s=0.05))
    f.admit({"x": np.float32([0])}, now=0.0, deadline=0.0001)
    assert f.close_at() == pytest.approx(0.05)


@settings(max_examples=20, deadline=None)
@given(n=st.integers(1, 9), size=st.integers(1, 12), width=st.integers(1, 4))
def test_stack_and_pad_equal(n, size, width):
    rs = np.random.RandomState(n * 100 + size)
    feats = [{"dense": rs.randn(width).astype(np.float32),
              "sparse": rs.randint(0, 50, 3).astype(np.int32)}
             for _ in range(n)]
    if n > size:
        for mod in (trouter, jrouter):
            with pytest.raises(ValueError, match="batch_size"):
                mod.stack_and_pad(feats, size)
        return
    (tb, tn), (jb, jn) = (trouter.stack_and_pad(feats, size),
                          jrouter.stack_and_pad(feats, size))
    assert tn == jn == n and tb.keys() == jb.keys()
    for k in tb:
        assert tb[k].dtype == jb[k].dtype
        np.testing.assert_array_equal(tb[k], jb[k])


def test_stack_and_pad_rejects_like_jax():
    a = {"dense": np.float32([1.0]), "sparse": np.int64([2])}
    for bad in ([], [a, {"dense": np.float32([3.0])}],
                [a, dict(a, emb=np.float32([4.0]))]):
        msgs = []
        for mod in (trouter, jrouter):
            with pytest.raises(ValueError) as e:
                mod.stack_and_pad(bad, 4)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_accepts_n_valid():
    def a(batch, n_valid=None):
        return batch

    def b(batch, **kw):
        return batch

    def c(batch):
        return batch
    for fn in (a, b, c, len):
        assert trouter.accepts_n_valid(fn) == jrouter.accepts_n_valid(fn)


# ---------------------------------------------------------------------------
# the async router and the sync MicroBatcher
# ---------------------------------------------------------------------------

def _double(batch, n_valid=None):
    return np.asarray(batch["x"][:, 0]) * 2.0


def _router_scenarios(mod):
    rc = mod.RouterConfig

    async def full_batch():
        r = mod.AsyncRouter(_double, mod.DeadlineBatcher(
            rc(max_batch=4, max_wait_s=30.0)))
        await r.start()
        res = await asyncio.gather(*[
            r.submit({"x": np.float32([i, 0])}) for i in range(4)])
        await r.stop()
        return [float(x) for x in res], r.dispatched_batches

    async def shed_and_flush():
        r = mod.AsyncRouter(_double, mod.DeadlineBatcher(
            rc(max_batch=8, max_queue=2, max_wait_s=30.0)))
        await r.start()
        t1 = asyncio.create_task(r.submit({"x": np.float32([1, 0])}))
        t2 = asyncio.create_task(r.submit({"x": np.float32([2, 0])}))
        await asyncio.sleep(0)
        try:
            await r.submit({"x": np.float32([3, 0])})
            shed = None
        except mod.LoadShedError as e:
            shed = e.reason
        await r.stop(flush=True)
        return [float(x) for x in await asyncio.gather(t1, t2)], shed

    async def swap():
        clock = types.SimpleNamespace(t=0.0)
        version, seen = {"v": 0}, []

        def score_fn(batch, n_valid=None):
            seen.append((version["v"], n_valid))
            return np.full(batch["x"].shape[0], float(version["v"]))

        r = mod.AsyncRouter(score_fn, mod.DeadlineBatcher(
            rc(max_batch=4, max_queue=64, max_wait_s=10.0)),
            clock=lambda: clock.t)
        await r.start()
        subs = [asyncio.ensure_future(r.submit({"x": np.zeros(3)}))
                for _ in range(6)]
        await asyncio.gather(*subs[:4])
        clock.t += 0.001
        got = await r.apply(lambda: version.__setitem__("v", 1) or "ok")
        await r.stop(flush=True)
        return got, seen, [float(s) for s in await asyncio.gather(*subs)]

    out = [asyncio.run(f()) for f in (full_batch, shed_and_flush, swap)]
    with pytest.raises(RuntimeError, match="not started"):
        asyncio.run(mod.AsyncRouter(_double, mod.DeadlineBatcher(
            rc(max_batch=4))).submit({"x": np.float32([0, 0])}))
    return out


def test_async_router_same_as_jax():
    got = _router_scenarios(trouter)
    assert got == _router_scenarios(jrouter)
    assert got[0] == ([0.0, 2.0, 4.0, 6.0], 1)
    assert got[1] == ([2.0, 4.0], "queue_full")
    assert got[2] == ("ok", [(0, 4), (1, 2)], [0.0] * 4 + [1.0] * 2)


def _micro(mod_serving, mod_router):
    t, seen = [0.0], []

    def score(batch, n_valid=None):
        seen.append((n_valid, batch["x"].shape[0]))
        return np.asarray(batch["x"][:, 0])

    mb = mod_serving.MicroBatcher(batch_size=4, score_fn=score,
                                  max_wait_ms=2.0, max_queue=7,
                                  clock=lambda: t[0])
    out = []
    mb.submit({"x": np.float32([7, 0])})
    out.append([float(o) for o in mb.poll()])
    t[0] = 0.003
    out.append([float(o) for o in mb.poll()])
    for i in range(7):
        mb.submit({"x": np.float32([i, 0])})
    with pytest.raises(mod_router.LoadShedError):
        mb.submit({"x": np.float32([9, 0])})
    with pytest.raises(ValueError, match="feature keys"):
        mb.submit({"y": np.float32([9, 0])})
    out.append([float(o) for o in mb.flush()])
    return out, seen, len(mb)


def test_micro_batcher_same_as_jax():
    got = _micro(tserving, trouter)
    assert got == _micro(jserving, jrouter)
    assert got[0] == [[], [7.0], [0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0]]
    assert got[1] == [(1, 4), (4, 4), (3, 4)]


def test_latency_profile_shape_and_order():
    calls = []

    def fn(b):
        calls.append(b["x"].shape)
        return b["x"] * 2
    prof = tserving.latency_profile(fn, {"x": np.ones(8, np.float32)},
                                    iters=5, warmup=2)
    assert len(calls) == 8
    assert prof["p50_ms"] <= prof["p95_ms"] <= prof["p99_ms"]
    assert prof["compile_ms"] >= 0.0


# ---------------------------------------------------------------------------
# count-min sketch and the backends' cache hooks
# ---------------------------------------------------------------------------

@settings(max_examples=15, deadline=None)
@given(width=st.integers(1, 3000), depth=st.integers(1, 5),
       seed=st.integers(0, 2 ** 31 - 1),
       n=st.integers(0, 500), hi=st.sampled_from([50, 1 << 20, 1 << 40]))
def test_count_min_sketch_table_equal(width, depth, seed, n, hi):
    keys = np.random.RandomState(seed % 1000).randint(
        0, hi, n).astype(np.int64)
    t = tcache.CountMinSketch(width, depth, seed)
    j = jcache.CountMinSketch(width, depth, seed)
    for part in (keys[: n // 2], keys[n // 2:].reshape(-1, 1)):
        t.update(part)
        j.update(part)
    assert t.width == j.width and t.total == j.total
    np.testing.assert_array_equal(t._t, j._t)
    np.testing.assert_array_equal(t.estimate(keys), j.estimate(keys))


def _hook_setup(kind, vocabs=(50, 30, 70), dim=8):
    jspec = JSpec(vocab_sizes=vocabs, dim=dim, kind=kind)
    tspec = TSpec(vocab_sizes=vocabs, dim=dim, kind=kind)
    jp = j_embedding_init(jax.random.PRNGKey(0), jspec)
    return (j_get_backend(kind), jspec, jp, t_get_backend(kind), tspec,
            _torch_params(jp))


@pytest.mark.parametrize("kind", ["full", "hashed"])
def test_cacheable_rows_equal_jax_hooks(kind):
    jb, jspec, jp, tb, tspec, tp = _hook_setup(kind)
    rs = np.random.RandomState(1)
    idx = np.stack([rs.randint(0, v, 40) for v in jspec.vocab_sizes], 1)
    ref = tb.lookup(tp, tspec, torch.from_numpy(idx.astype(np.int32)))
    for f in range(jspec.n_fields):
        got = tb.cacheable_rows(tp, tspec, f, idx[:, f])
        want = np.asarray(jb.cacheable_rows(jp, jspec, f, idx[:, f]))
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ref[:, f].numpy())


def test_cache_hook_protocol():
    from repro_torch.nn.embedding_backends.base import EmbeddingBackend
    assert EmbeddingBackend.cacheable_rows is None
    assert EmbeddingBackend.affected_rows is None
    for kind in ("robe", "qrobe", "tt"):
        assert t_get_backend(kind).cacheable_rows is None
    assert t_get_backend("full").affected_rows is None
    _, _, _, _, tspec, tp = _hook_setup("full")
    assert tcache.HotRowCache.for_backend(t_get_backend("robe"), tspec,
                                          tp) is None
    with pytest.raises(ValueError, match="declines"):
        tcache.HotRowCache(t_get_backend("robe"), tspec, tp)


@settings(max_examples=20, deadline=None)
@given(buckets=st.sampled_from([0, 1, 4, 7, 64]),
       n_touched=st.integers(0, 20), seed=st.integers(0, 10 ** 6))
def test_hashed_affected_rows_equal(buckets, n_touched, seed):
    vocabs = (50, 30, 70)
    jspec = JSpec(vocab_sizes=vocabs, dim=4, kind="hashed",
                  hashed_buckets=buckets)
    tspec = TSpec(vocab_sizes=vocabs, dim=4, kind="hashed",
                  hashed_buckets=buckets)
    rs = np.random.RandomState(seed)
    for f, v in enumerate(vocabs):
        touched = rs.randint(0, v, n_touched)
        cand = rs.randint(0, v, 25)
        np.testing.assert_array_equal(
            t_get_backend("hashed").affected_rows(tspec, f, touched, cand),
            j_get_backend("hashed").affected_rows(jspec, f, touched, cand))


# ---------------------------------------------------------------------------
# the hot-row cache against the JAX cache
# ---------------------------------------------------------------------------

def _same_cache(tc, jc):
    assert list(tc._rows) == list(jc._rows)      # keys and insertion order
    for k in jc._rows:
        np.testing.assert_array_equal(tc._rows[k], np.asarray(jc._rows[k]))
    assert (tc.hits, tc.misses) == (jc.hits, jc.misses)
    np.testing.assert_array_equal(tc.sketch._t, jc.sketch._t)
    assert tc.stats() == jc.stats()


@pytest.mark.parametrize("kind", ["full", "hashed"])
@pytest.mark.parametrize("capacity", [64, 2048])
def test_hot_row_cache_state_equal_on_zipf_traffic(kind, capacity):
    jb, jspec, jp, tb, tspec, tp = _hook_setup(kind, vocabs=VOCABS)
    kw = dict(capacity=capacity, sketch_width=1 << 12, admit_threshold=2,
              seed=3)
    tc = tcache.HotRowCache(tb, tspec, tp, **kw)
    jc = jcache.HotRowCache(jb, jspec, jp, **kw)
    stream = jdata.RequestStream(jdata.CtrDataConfig(
        vocab_sizes=VOCABS, batch_size=128, zipf_exponent=1.05))
    warm = stream.id_batches(6, start_step=100)
    tc.warm(warm)
    jc.warm(warm)
    _same_cache(tc, jc)
    for s, nv in ((0, None), (1, 100), (2, 1), (3, None)):
        ids = stream.id_batches(1, start_step=s)[0]
        np.testing.assert_array_equal(tc.lookup(ids, nv),
                                      np.asarray(jc.lookup(ids, nv)))
        _same_cache(tc, jc)
    assert len(tc._rows) <= capacity and tc.hits > 0
    # invalidation and resets agree too
    touched = {0: list(range(0, 400, 3)), "2": [5, 6, 7]}
    assert tc.invalidate_manifest(touched) == jc.invalidate_manifest(touched)
    _same_cache(tc, jc)
    assert tc.clear() == jc.clear()
    tc.reset()
    jc.reset()
    _same_cache(tc, jc)


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def servers():
    jcfg, tcfg = _server_cfgs()
    js = jserver.EmbeddingServer(jcfg)
    ts = tserver.EmbeddingServer(tcfg, params={
        b: _torch_params(js.params(b)) for b in jcfg.backends}, device="cpu")
    return js, ts


def test_server_config_fields_equal():
    jcfg, tcfg = _server_cfgs(model_dir="/x", sketch_width=100,
                              cache_admit_threshold=3)
    assert ({f.name for f in dataclasses.fields(jcfg)}
            == {f.name for f in dataclasses.fields(tcfg)})
    for b in jcfg.backends:
        jr, tr = jcfg.recsys_cfg(b), tcfg.recsys_cfg(b)
        assert (jr.robe_size, jr.bot_mlp, jr.embedding) == \
            (tr.robe_size, tr.bot_mlp, tr.embedding)


def test_server_caches_front_full_and_hashed(servers):
    js, ts = servers
    for b in ts.backends:
        assert (ts.cache(b) is None) == (js.cache(b) is None), b
    assert ts.cache("full") is not None and ts.cache("hashed") is not None
    assert ts.cache("robe") is None and ts.cache("tt") is None
    _, tcfg = _server_cfgs(cache_capacity=0)
    bare = tserver.EmbeddingServer(tcfg, params={
        b: ts.params(b) for b in tcfg.backends}, device="cpu")
    assert all(bare.cache(b) is None for b in bare.backends)
    assert bare.cache_stats("full") is None


@pytest.mark.parametrize("backend", ["full", "hashed"])
def test_server_cached_scores_bit_exact_and_match_jax(servers, backend):
    js, ts = servers
    js.reset_caches()
    ts.reset_caches()
    for step, n in ((0, 32), (1, 16), (2, 32)):
        batch = _server_batch(n=n, step=step)
        cached = ts.score(backend, batch, n - 3)
        direct = ts.score(backend, batch, n - 3, use_cache=False)
        np.testing.assert_array_equal(cached, direct)
        want = js.score(backend, batch, n - 3)
        assert cached.shape == want.shape == (n - 3,)
        np.testing.assert_allclose(cached, want, rtol=1e-5, atol=1e-5)
    assert ts.cache(backend).sketch.total > 0
    _same_cache(ts.cache(backend), js.cache(backend))


def test_server_routes_every_backend_like_jax(servers):
    js, ts = servers
    batch = _server_batch()
    for b in ("full", "robe", "hashed", "tt"):
        for uc in (True, False):
            np.testing.assert_allclose(
                ts.score(b, batch, use_cache=uc),
                js.score(b, batch, use_cache=uc), rtol=1e-5, atol=1e-5,
                err_msg=b)
    with pytest.raises(KeyError, match="not resident"):
        ts.score("nope", batch)
    fn = ts.score_fn("full", use_cache=False)
    assert fn.__name__ == "score_full"
    padded, n = trouter.stack_and_pad(_mini_requests(5), 16)
    np.testing.assert_array_equal(fn(padded, n_valid=n),
                                  ts.score("full", padded)[:5])


def test_server_cache_bookkeeping(servers):
    js, ts = servers
    ids = jdata.RequestStream(jdata.CtrDataConfig(
        vocab_sizes=VOCABS, batch_size=64)).id_batches(4, start_step=50)
    for s in (js, ts):
        s.reset_caches()
        s.warm_caches(ids)
    for b in ("full", "hashed"):
        _same_cache(ts.cache(b), js.cache(b))
        assert ts.cache_stats(b) == js.cache_stats(b)
        assert ts.cache_stats(b)["resident_rows"] > 0
    assert ts.cache_stats("robe") is None
    for s in (js, ts):
        s.score("full", _server_batch())
        s.reset_cache_stats()
    assert ts.cache_stats("full")["hits"] == 0
    _same_cache(ts.cache("full"), js.cache("full"))
    assert ts.pushed_step("full") is None


# ---------------------------------------------------------------------------
# the replay (virtual clock) and the grid
# ---------------------------------------------------------------------------

def _replay_both(cfg_kw, n, arr_seed, svc_kw=None, events_t=None,
                 events_j=None, **kw):
    """The same trace through each package's ``replay``: (port, JAX)."""
    out = []
    for mod, events in ((treplay, events_t), (jreplay, events_j)):
        cfg = mod.ReplayConfig(**cfg_kw)
        reqs = _mini_requests(n)
        arr = jdata.poisson_arrivals(cfg.rate_hz, n, seed=arr_seed)
        out.append(mod.replay(mod.synthetic_service(**(svc_kw or {})),
                              reqs, arr, cfg, events=events, **kw))
    return out


def _same_report(t, j):
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.as_row() == j.as_row()


@pytest.mark.parametrize("policy", ["deadline", "fixed"])
@pytest.mark.parametrize("cell", [
    (dict(n_requests=256, rate_hz=2000.0, deadline_s=0.025, max_batch=32),
     1, None),
    (dict(n_requests=1024, rate_hz=2000.0, deadline_s=0.025, max_batch=64),
     2, None),
    (dict(n_requests=512, rate_hz=5000.0, deadline_s=None, max_batch=16,
          max_queue=32, max_wait_s=0.002), 3, dict(base_s=0.050)),
    (dict(n_requests=64, rate_hz=1000.0, deadline_s=0.001, max_batch=8,
          init_service_s=0.005), 4, dict(base_s=0.005))])
def test_replay_single_server_equal(policy, cell):
    kw, seed, svc = cell
    t, j = _replay_both(dict(kw, policy=policy), kw["n_requests"], seed, svc)
    _same_report(t, j)
    assert t.completed + t.shed == kw["n_requests"]


def test_replay_with_push_events_equal(fake_clocks):
    span = float(jdata.poisson_arrivals(3000.0, 256, seed=1)[-1])
    seen = {"t": [], "j": []}

    def events(tag):
        return [(span * (k + 1) / 4, lambda k=k: seen[tag].append(k))
                for k in range(3)]
    t, j = _replay_both(dict(n_requests=256, rate_hz=3000.0, max_batch=16,
                             seed=9), 256, 1, events_t=events("t"),
                        events_j=events("j"))
    _same_report(t, j)
    assert t.pushes == 3 and t.shed == 0 and seen["t"] == seen["j"]
    row = t.as_row()
    assert {"pushes", "push_p50_ms", "push_max_ms",
            "mean_staleness_s"} <= set(row)
    assert row["push_p50_ms"] == 0.5


def test_replay_fleet_of_four_equal(fake_clocks):
    kw = dict(n_requests=512, rate_hz=8000.0, deadline_s=None,
              max_batch=16, max_queue=32, max_wait_s=0.004)
    t, j = _replay_both(kw, 512, 3, dict(base_s=0.008), n_replicas=4)
    _same_report(t, j)
    assert t.shed == 0 and all(b > 0 for b in t.replica_batches)
    one, _ = _replay_both(kw, 512, 3, dict(base_s=0.008))
    assert one.shed > 0 and t.p99_ms < one.p99_ms


def test_replay_fleet_retry_equal():
    cfg_kw = dict(n_requests=128, rate_hz=2000.0, deadline_s=0.010,
                  max_batch=16)
    reps = []
    for mod in (treplay, jreplay):
        rmod = trouter if mod is treplay else jrouter
        rc = rmod.RouterConfig
        batchers = [rmod.DeadlineBatcher(rc(max_batch=16,
                                            init_service_s=0.050)),
                    rmod.DeadlineBatcher(rc(max_batch=16,
                                            init_service_s=0.001))]
        reps.append(mod.replay(
            mod.synthetic_service(base_s=0.001, per_row_s=1e-5),
            _mini_requests(128), jdata.poisson_arrivals(2000.0, 128, seed=6),
            mod.ReplayConfig(**cfg_kw), n_replicas=2, batchers=batchers))
    _same_report(*reps)
    assert reps[0].retried > 0 and reps[0].replica_batches[0] == 0


@pytest.mark.parametrize("staggered", [True, False])
def test_rollouts_equal_and_never_overlap(fake_clocks, staggered):
    def events(tag):
        fns = [lambda r=r: None for r in range(3)]
        if staggered:
            return [(0.030, list(enumerate(fns)))]
        return [(0.030, fn, r) for r, fn in enumerate(fns)]
    t, j = _replay_both(dict(n_requests=512, rate_hz=4000.0, deadline_s=None,
                             max_batch=16, max_wait_s=0.004), 512, 5,
                        n_replicas=3, events_t=events("t"),
                        events_j=events("j"))
    _same_report(t, j)
    assert t.pushes == 3 and [e[0] for e in t.push_log] == [0, 1, 2]
    if staggered:
        for prev, nxt in zip(t.push_log, t.push_log[1:]):
            assert nxt[2] >= prev[3]              # never two mid-swap
    else:
        assert all(e[1] == 0.030 for e in t.push_log)
    assert all(b > 0 for b in t.replica_batches)


def test_replay_edge_cases_equal(fake_clocks):
    cfg = dict(n_requests=64, rate_hz=1000.0, deadline_s=0.001, max_batch=8,
               init_service_s=0.005)
    t, j = _replay_both(cfg, 64, 4, dict(base_s=0.005),
                        events_t=[(0.010, lambda: None)],
                        events_j=[(0.010, lambda: None)])
    _same_report(t, j)
    assert t.shed == 64 and t.makespan_s >= 0.06 and t.qps == 0.0
    reps = [mod.replay(mod.synthetic_service(), _mini_requests(1),
                       np.asarray([0.0]), mod.ReplayConfig(
                           n_requests=1, deadline_s=None, max_batch=4,
                           max_wait_s=0.010)) for mod in (treplay, jreplay)]
    _same_report(*reps)
    for bad in (dict(n_replicas=0), dict(events=[(0.0, lambda: None, 5)])):
        with pytest.raises(ValueError):
            treplay.replay(treplay.synthetic_service(), _mini_requests(4),
                           np.arange(4.0), treplay.ReplayConfig(), **bad)
    with pytest.raises(ValueError, match="unknown policy"):
        treplay.make_batcher(treplay.ReplayConfig(policy="nope"))


def test_run_grid_rows_equal_jax_and_order_independent(servers):
    js, ts = servers
    rows = {}
    for tag, srv, mod in (("t", ts, treplay), ("j", js, jreplay)):
        cache = srv.cache("full")

        def svc(batch, n_valid, cache=cache):
            cache.lookup(batch["sparse"], n_valid)   # deterministic traffic
            return 1e-3
        base = mod.ReplayConfig(n_requests=192, rate_hz=2000.0,
                                max_batch=16)
        kw = dict(policies=("deadline", "fixed"), backends=("full",),
                  base=base, warm_batches=12, service=svc)
        rows[tag] = (mod.run_grid(srv, zipfs=(1.05, 4.0), **kw),
                     mod.run_grid(srv, zipfs=(4.0, 1.05), **kw))
    assert rows["t"][0] == rows["j"][0]
    key = lambda r: (r["zipf"], r["policy"])          # noqa: E731
    assert sorted(rows["t"][0], key=key) == sorted(rows["t"][1], key=key)
    by = {(r["zipf"], r["policy"]): r for r in rows["t"][0]}
    assert by[(1.05, "deadline")]["hit_rate"] > by[(4.0, "deadline")][
        "hit_rate"]


def test_run_cell_measured_row(servers):
    _, ts = servers
    ts.reset_caches()
    row = treplay.run_cell(ts, "hashed", treplay.ReplayConfig(
        n_requests=256, rate_hz=2000.0, deadline_s=0.025, max_batch=32),
        zipf=1.05, warm_batches=20)
    for k in ("p50_ms", "p99_ms", "qps", "shed", "hit_rate", "backend",
              "policy", "completed", "mean_batch", "cache_resident"):
        assert k in row, k
    assert row["completed"] + row["shed"] == 256
    assert row["hit_rate"] > 0.3 and row["p50_ms"] <= row["p99_ms"]
    robe = treplay.run_cell(ts, "robe", treplay.ReplayConfig(
        n_requests=64, max_batch=16), warm_batches=2)
    assert "hit_rate" not in robe


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fleets():
    jcfg, tcfg = _server_cfgs(backends=("full",))
    jf = jfleet.ReplicaFleet(jcfg, n_replicas=3)
    tf = tfleet.ReplicaFleet(tcfg, n_replicas=3, params={
        "full": _torch_params(jf.replicas[0].params("full"))}, device="cpu")
    return jf, tf


def test_fleet_shares_params_and_scores_like_jax(fleets):
    jf, tf = fleets
    assert len(tf) == tf.n_replicas == 3 and tf.backends == ("full",)
    base = tf.replicas[0].params("full")["embedding"]["table"]
    assert all(r.params("full")["embedding"]["table"] is base
               for r in tf.replicas)
    for step in range(2):
        batch = _server_batch(n=16, step=step)
        want = jf.score("full", batch, replica=0, use_cache=False)
        for r in range(3):
            got = tf.score("full", batch, replica=r, use_cache=False)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(
                got, tf.score("full", batch, replica=0, use_cache=True))
        np.testing.assert_array_equal(
            tf.score("full", batch, use_cache=False),
            tf.score("full", batch, replica=1, use_cache=False))
    assert [len(fns) for fns in (tf.score_fns("full"),)] == [3]
    assert tf.pushed_steps("full") == [None] * 3
    with pytest.raises(ValueError):
        tfleet.ReplicaFleet(_server_cfgs()[1], n_replicas=0, device="cpu")


@settings(max_examples=25, deadline=None)
@given(loads=st.lists(st.integers(0, 3), min_size=3, max_size=3),
       free=st.lists(st.sampled_from([0.0, 0.01, 0.02]), min_size=3,
                     max_size=3),
       inits=st.lists(st.sampled_from([0.001, 0.02]), min_size=3,
                      max_size=3),
       deadline=st.one_of(st.none(), st.sampled_from([0.005, 0.03])))
def test_fleet_admission_same_as_jax(fleets, loads, free, inits, deadline):
    out = []
    for f, rmod in zip(fleets, (jrouter, trouter)):
        bs = [rmod.DeadlineBatcher(rmod.RouterConfig(
            max_batch=8, max_queue=3, init_service_s=i)) for i in inits]
        for b, n in zip(bs, loads):
            for _ in range(n):
                b.admit({"x": np.float32([0])}, now=0.0)
        res = [f.admission_order(bs, free)]
        for _ in range(3):
            try:
                res.append(f.admit(bs, {"x": np.float32([1])}, now=0.0,
                                   deadline=deadline, free=free))
            except rmod.LoadShedError as e:
                res.append(e.reason)
        res.append([len(b) for b in bs])
        out.append(res)
    assert out[0] == out[1]


def test_fleet_cell_row(fleets):
    _, tf = fleets
    tf.reset_caches()
    row = treplay.run_fleet_cell(tf, "full", treplay.ReplayConfig(
        n_requests=256, rate_hz=4000.0, deadline_s=0.025, max_batch=32),
        zipf=1.05, warm_batches=8)
    assert row["n_replicas"] == 3 and row["completed"] + row["shed"] == 256
    for k in ("retried", "hit_rate", "cache_resident", "p99_ms", "qps"):
        assert k in row, k
    assert "push_log" not in row and "replica_batches" not in row
