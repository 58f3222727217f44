"""The port's online training and model push against the JAX package's, on
the CPU.

* ``OnlineTrainer`` on ``full``, ``hashed`` and ``qrobe`` (adagrad, the
  JAX tests' sizes), each package from the same params and stream: losses
  within 1e-5, the same publish cadence, kinds and changed-leaf counts,
  the same touched maps; each package's publish dir restores in the other
  bit for bit; rows (``full``) and bucket rows (``hashed``) outside the
  touched map are bit-stable across a publish interval;
* ``EmbeddingServer.push``: the same ``PushReport`` kind, ``invalidated``
  and ``cache_cleared`` as the JAX server for the same warm traffic,
  anchored and unanchored deltas; cache-on scores equal cache-off scores
  after every push; the swap rebinds and never writes into the old
  tensors;
* the refusal of optimizers that move zero-gradient rows, and
  ``FaultPlan``-driven ``run`` with a stub re-slice: the same restarts,
  NaN events, stragglers, re-slices and publishes as the JAX run;
* ``FaultClock``/``FaultPlan``, ``RowRecorder``, ``HotRowCache``
  invalidation and ``run_push_cell``.

Every test runs on the CPU: no kernel may be launched.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.data.synthetic_ctr import CtrDataConfig, CtrStream
from repro.models.recsys import RecsysConfig as JRecsysConfig
from repro.serve import server as jserver
from repro.train import checkpoint as jck
from repro.train import elastic as jelastic
from repro.train import online as jonline
from repro.train import optimizer as jopt
from repro.train import train_loop as jtl
from repro_torch import kernels as tk
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.models.recsys import RecsysConfig as TRecsysConfig
from repro_torch.nn.embedding_backends.hashed import _m, qr_layout
from repro_torch.serve import replay as treplay
from repro_torch.serve import server as tserver
from repro_torch.train import checkpoint as tck
from repro_torch.train import elastic as telastic
from repro_torch.train import online as tonline
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as ttl
from repro_torch.tree import leaves

VOCABS = (1200, 600, 1800)
LOSS_TOL = 1e-5


@pytest.fixture(autouse=True)
def _no_launches():
    tk.reset_launches()
    yield
    assert all(n == 0 for n in tk.launch_counts().values())


def _cfgs(embedding="full", vocabs=VOCABS):
    kw = dict(name=f"online-{embedding}", arch="dlrm", vocab_sizes=vocabs,
              embed_dim=8, n_dense=4, bot_mlp=(16, 8), top_mlp=(16, 1),
              embedding=embedding, robe_size=2048)
    return JRecsysConfig(**kw), TRecsysConfig(**kw)


def _stream(vocabs=VOCABS, batch=64, drift=10, seed=5):
    return CtrStream(CtrDataConfig(vocab_sizes=vocabs, n_dense=4,
                                   batch_size=batch, drift_period=drift,
                                   seed=seed))


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(jax.device_get(x)), tree)


def _to_torch(tree):
    return params_from_numpy(_np(tree), "cpu")


def _trainers(kind, jpub, tpub, seed=0, **online_kw):
    """A JAX ``OnlineTrainer`` and the port's from the same params."""
    jcfg, tcfg = _cfgs(kind)
    jtr = jonline.OnlineTrainer(jcfg, _stream(), jonline.OnlineConfig(
        publish_dir=jpub, **online_kw), seed=seed)
    ttr = tonline.OnlineTrainer(tcfg, _stream(), tonline.OnlineConfig(
        publish_dir=tpub, **online_kw),
        params=_to_torch(jtr.state["params"]))
    return jtr, ttr


def _manifests(pub):
    out = {}
    for d in sorted(os.listdir(pub)):
        with open(os.path.join(pub, d, "manifest.json")) as f:
            out[d] = json.load(f)
    return out


def _assert_same_leaves(got_np, want_np):
    g, w = jax.tree.leaves(got_np), jax.tree.leaves(want_np)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# FaultClock / FaultPlan / RowRecorder
# ---------------------------------------------------------------------------

def test_fault_clock_and_plan_wrappers_match_jax():
    out = []
    for mod, step_t in ((jelastic, np.int32), (telastic, torch.tensor)):
        plan = mod.FaultPlan(slow_steps={2: 1.5}, nan_steps={1},
                             raise_steps={3: "node lost"}, base_dt=0.25)
        seen = []
        step_fn = plan.wrap_step_fn(lambda s, b: seen.append(int(s["step"]))
                                    or (s, {}))
        batch_at = plan.wrap_batch_at(lambda k: {
            "dense": np.ones((2, 2), np.float32) * k,
            "sparse": np.full((2, 1), k, np.int32)})
        log = []
        for k in range(5):
            try:
                step_fn({"step": step_t(k)}, None)
                log.append(("ok", plan.clock()))
            except RuntimeError as e:
                log.append(("raised", str(e), plan.clock()))
            b = batch_at(k)
            log.append((bool(np.isnan(b["dense"]).all()),
                        b["sparse"].dtype.str, int(b["sparse"][0, 0])))
        step_fn({"step": step_t(3)}, None)          # the retry succeeds
        clock = mod.FaultClock(2.0)
        clock.advance(0.5)
        out.append((log, seen, plan.clock(), clock()))
    assert out[0] == out[1]
    assert out[1][0][6] == ("raised", "node lost", 2.0)


def test_row_recorder_same_as_jax():
    batches = [{"sparse": np.array([[3, 5], [3, 9]]),
                "sparse_bag": np.array([[[7], [5]]])},
               {"sparse": np.array([[1, 2]])}, {"dense": np.zeros(3)}]
    got = []
    for mod in (jonline, tonline):
        rec = mod.RowRecorder(2)
        for b in batches:
            rec.record(b)
        got.append((rec.drain(), rec.drain()))
    assert got[0] == got[1] == ({0: [1, 3, 7], 1: [2, 5, 9]}, {})


# ---------------------------------------------------------------------------
# OnlineTrainer against the JAX trainer
# ---------------------------------------------------------------------------

def _teacher_forced(jtr, ttr) -> None:
    """Make each step of the port's trainer start from the JAX trainer's
    state before that step (recorded as the JAX run goes; run the JAX
    trainer first).  qrobe's ``project`` rounds w / scale to int8 codes,
    so a last-bit difference of the two packages' summation orders flips
    a code at a rounding edge and two free runs part by whole quanta
    within a few steps; from the same state each step's loss agrees."""
    states = {}
    jstep = jtr._step_fn

    def record(state, batch):
        states[int(state["step"])] = jax.tree.map(np.array, state)
        return jstep(state, batch)
    jtr._step_fn = record
    tstep = ttr._step_fn

    def forced(state, batch):
        return tstep(_to_torch(states[int(state["step"])]), batch)
    ttr._step_fn = forced


@pytest.fixture(scope="module", params=["full", "hashed", "qrobe"])
def runs(request, tmp_path_factory):
    """24 steps of each package's trainer on the same stream from the same
    params, publishing every 8 (full, delta, delta, full).  full and
    hashed run free; qrobe's port steps start from the JAX states
    (``_teacher_forced``)."""
    kind = request.param
    jpub = str(tmp_path_factory.mktemp(f"jpub-{kind}"))
    tpub = str(tmp_path_factory.mktemp(f"tpub-{kind}"))
    jtr, ttr = _trainers(kind, jpub, tpub, publish_every=8, full_every=3)
    if kind == "qrobe":
        _teacher_forced(jtr, ttr)
    jrep = jtr.run(24)
    return kind, jrep, ttr.run(24), jpub, tpub


def test_online_losses_and_publishes_match_jax(runs):
    kind, jrep, trep, jpub, tpub = runs
    assert trep.steps_done == jrep.steps_done == 24
    assert len(trep.losses) == 24
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=0,
                               atol=LOSS_TOL)
    assert trep.final_loss == trep.losses[-1]
    key = lambda p: (p.step, p.kind, p.n_leaves, p.n_changed,   # noqa: E731
                     p.n_touched)
    assert [key(p) for p in trep.publishes] == \
        [key(p) for p in jrep.publishes]
    assert [(p.step, p.kind) for p in trep.publishes] == \
        [(0, "full"), (8, "delta"), (16, "delta"), (24, "full")]
    assert all(p.n_touched > 0 for p in trep.publishes[1:])
    assert (trep.restarts, trep.nan_events, trep.reslices) == (0, 0, 0)


def test_online_touched_maps_match_jax(runs):
    _, _, _, jpub, tpub = runs
    jm, tm = _manifests(jpub), _manifests(tpub)
    assert sorted(jm) == sorted(tm)
    for d in jm:
        assert tm[d]["step"] == jm[d]["step"]
        assert tm[d].get("touched") == jm[d].get("touched"), d
        assert tm[d].get("base_step") == jm[d].get("base_step"), d
        assert [m.get("changed") for m in tm[d]["leaves"]] == \
            [m.get("changed") for m in jm[d]["leaves"]], d


@pytest.mark.parametrize("step", [None, 8, 16])
def test_publish_dirs_restore_across_packages(runs, step):
    _, jrep, trep, jpub, tpub = runs
    # the JAX publish in the port
    jtree, jman = jck.restore_delta(jpub, _np(jrep.state["params"]),
                                    step=step)
    ttree, tman = tck.restore_delta(jpub, trep.state["params"], step=step)
    _assert_same_leaves(tree_to_numpy(ttree), jtree)
    assert tman["step"] == jman["step"] and tman["touched"] == \
        jman["touched"] and tman["chain"] == jman["chain"]
    # the port's publish in the JAX package
    ptree, pman = tck.restore_delta(tpub, trep.state["params"], step=step)
    jtree2, jman2 = jck.restore_delta(tpub, _np(jrep.state["params"]),
                                      step=step)
    _assert_same_leaves(jtree2, tree_to_numpy(ptree))
    assert pman["step"] == jman2["step"] == (24 if step is None else step)
    if step is None:
        _assert_same_leaves(tree_to_numpy(ptree),
                            tree_to_numpy(trep.state["params"]))


def test_untouched_rows_are_bitstable(runs):
    kind, _, trep, _, tpub = runs
    _, tcfg = _cfgs(kind)
    spec = tcfg.embedding_spec()
    base, _ = tck.restore_delta(tpub, trep.state["params"], step=0)
    new, man = tck.restore_delta(tpub, trep.state["params"], step=8)
    touched = {int(f): np.asarray(v, np.int64)
               for f, v in man["touched"].items()}
    if kind == "full":
        old_t = base["embedding"]["table"].numpy()
        new_t = new["embedding"]["table"].numpy()
        for f, vocab in enumerate(spec.vocab_sizes):
            t = touched.get(f, np.zeros(0, np.int64))
            rows = np.setdiff1d(np.arange(vocab), t) + int(spec.offsets[f])
            np.testing.assert_array_equal(old_t[rows], new_t[rows])
            assert not np.array_equal(old_t[t + int(spec.offsets[f])],
                                      new_t[t + int(spec.offsets[f])])
    elif kind == "hashed":
        m = _m(spec)
        q_rows, q_off, r_off = qr_layout(spec.vocab_sizes, m)
        for name, rows_of in (
                ("q_table", lambda f, t: t // m + int(q_off[f])),
                ("r_table", lambda f, t: t % m + int(r_off[f]))):
            old_t = base["embedding"][name].numpy()
            new_t = new["embedding"][name].numpy()
            hit = np.zeros(old_t.shape[0], bool)
            for f, t in touched.items():
                hit[rows_of(f, t)] = True
            np.testing.assert_array_equal(old_t[~hit], new_t[~hit])
            assert not np.array_equal(old_t[hit], new_t[hit])
    else:
        # qrobe: the publish keeps its int8 codes
        dtypes = {x.dtype for x in leaves(new["embedding"])}
        assert torch.int8 in dtypes and man["step"] == 8


# ---------------------------------------------------------------------------
# optimizer refusal, fault drill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,momentum", [
    ("adam", 0.0), ("adamw", 0.0), ("adafactor", 0.0), ("sgd", 0.0),
    ("adagrad", 0.0), ("sgd", 0.9)])
def test_optimizer_refusal_same_as_jax(tmp_path, kind, momentum):
    """adam, adamw and adafactor carry moment state that moves zero-gradient
    rows and are refused unless acknowledged; sgd and adagrad pass.  The
    decision is by kind, in both packages, so sgd with momentum passes
    too."""
    jcfg, tcfg = _cfgs("full")
    decisions = []
    for mod, cfg, om in ((jonline, jcfg, jopt), (tonline, tcfg, topt)):
        opt = om.make_optimizer(om.OptimizerConfig(kind=kind, lr=1e-3,
                                                   momentum=momentum))
        kw = dict(optimizer=opt)
        if mod is tonline:
            kw["device"] = "cpu"
        try:
            mod.OnlineTrainer(cfg, _stream(), mod.OnlineConfig(
                publish_dir=str(tmp_path)), **kw)
            decisions.append("accepted")
        except ValueError as e:
            assert "zero-gradient" in str(e)
            decisions.append("refused")
        mod.OnlineTrainer(cfg, _stream(), mod.OnlineConfig(
            publish_dir=str(tmp_path), unsafe_optimizer=True), **kw)
    assert decisions[0] == decisions[1]
    assert decisions[0] == ("accepted" if kind in ("sgd", "adagrad")
                            else "refused")


def test_trainer_device_default_and_init(tmp_path):
    _, tcfg = _cfgs("hashed")
    tr = tonline.OnlineTrainer(tcfg, _stream(), tonline.OnlineConfig(
        publish_dir=str(tmp_path)), device="cpu", seed=3)
    again = tonline.OnlineTrainer(tcfg, _stream(), tonline.OnlineConfig(
        publish_dir=str(tmp_path)), device="cpu", seed=3)
    for a, b in zip(leaves(tr.state["params"]),
                    leaves(again.state["params"])):
        assert a.device.type == "cpu" and torch.equal(a, b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tonline.OnlineTrainer(tcfg, _stream(), tonline.OnlineConfig(
                publish_dir=str(tmp_path)))


def test_fault_plan_run_same_as_jax(tmp_path):
    """``run(fault_plan=, reslice_fn=, ckpt_dir=)``: a straggler run that
    trips the stub re-slice, a NaN batch and a node failure, with fault
    checkpoints — the same counts, publishes and losses as the JAX run."""
    vocabs = (1200, 600, 1800, 400)
    reports = []
    params = None
    for pkg, mod, el, tl in (("j", jonline, jelastic, jtl),
                             ("t", tonline, telastic, ttl)):
        kind = "full"
        cfg = (JRecsysConfig if pkg == "j" else TRecsysConfig)(
            name="online-e2e", arch="dlrm", vocab_sizes=vocabs, embed_dim=8,
            n_dense=4, bot_mlp=(16, 8), top_mlp=(16, 1), embedding=kind)
        plan = el.FaultPlan(slow_steps={14: 1.0, 15: 1.0, 16: 1.0},
                            nan_steps={5}, raise_steps={33: "node lost"},
                            base_dt=0.01)
        kw = {} if params is None else dict(params=_to_torch(params))
        tr = mod.OnlineTrainer(
            cfg, _stream(vocabs=vocabs),
            mod.OnlineConfig(publish_dir=str(tmp_path / f"pub-{pkg}"),
                             publish_every=10),
            train_cfg=tl.TrainConfig(checkpoint_every=10_000,
                                     straggler_patience=3), **kw)
        if params is None:
            params = _np(tr.state["params"])
        reslices = []

        def stub(state, step, tr=tr, plan=plan, reslices=reslices):
            reslices.append(step)
            return state, plan.wrap_step_fn(tr._step_fn)

        rep = tr.run(40, fault_plan=plan, reslice_fn=stub,
                     ckpt_dir=str(tmp_path / f"ft-{pkg}"))
        reports.append((rep, reslices))
    (jrep, jres), (trep, tres) = reports
    got = [(r.steps_done, r.restarts, r.nan_events, r.straggler_steps,
            r.reslices, [(p.step, p.kind, p.n_touched) for p in r.publishes])
           for r in (jrep, trep)]
    assert got[0] == got[1]
    assert tres == jres == [17]
    assert trep.restarts == 1 and trep.nan_events == 1
    assert [p.step for p in trep.publishes] == [0, 10, 20, 30, 40]
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=0,
                               atol=LOSS_TOL)


# ---------------------------------------------------------------------------
# the hot-row cache under a push, and EmbeddingServer.push
# ---------------------------------------------------------------------------

def _server_cfgs(pub, backends=("full",), vocabs=VOCABS, cache=4096):
    kw = dict(vocab_sizes=vocabs, embed_dim=8, n_dense=4, bot_mlp=(16, 8),
              top_mlp=(16, 1), backends=backends, cache_capacity=cache,
              model_dir=pub)
    return jserver.ServerConfig(**kw), tserver.ServerConfig(**kw)


def _servers(jpub, tpub, backends=("full",)):
    jcfg, _ = _server_cfgs(jpub, backends)
    _, tcfg = _server_cfgs(tpub, backends)
    js = jserver.EmbeddingServer(jcfg)
    ts = tserver.EmbeddingServer(tcfg, params={
        b: _to_torch(js.params(b)) for b in backends}, device="cpu")
    return js, ts


def _warm_ids(n=8):
    s = _stream()
    return [s.batch_at(i)["sparse"] for i in range(n)]


def _probe():
    b = _stream().batch_at(999)
    return {"dense": b["dense"], "sparse": b["sparse"]}


def _report_key(r):
    return (r.backend, r.step, r.kind, r.invalidated, r.cache_cleared)


def _check_after_push(js, ts, backend):
    probe = _probe()
    on = ts.score(backend, probe, use_cache=True)
    np.testing.assert_array_equal(on, ts.score(backend, probe,
                                               use_cache=False))
    np.testing.assert_allclose(on, js.score(backend, probe), rtol=1e-5,
                               atol=1e-5)
    cache = ts.cache(backend)
    assert set(cache._rows) == set(js.cache(backend)._rows)
    spec = ts.recsys_config(backend).embedding_spec()
    off = spec.offsets
    for g, row in cache._rows.items():          # survivors are exact too
        f = int(np.searchsorted(off, g, side="right") - 1)
        want = ts.params(backend)["embedding"]
        np.testing.assert_array_equal(
            row, cache.backend.cacheable_rows(want, spec, f,
                                              np.int64([g - off[f]]))[0])


@pytest.mark.parametrize("backend", ["full", "hashed"])
def test_server_push_reports_match_jax(tmp_path, backend):
    jpub, tpub = str(tmp_path / "j"), str(tmp_path / "t")
    jtr, ttr = _trainers(backend, jpub, tpub, publish_every=8,
                         full_every=10)
    jtr.run(24)
    ttr.run(24)
    js, ts = _servers(jpub, tpub, (backend,))
    old = ts.params(backend)
    old_leaves = [x.clone() for x in leaves(old)]
    assert ts.pushed_step(backend) is None
    reports = []
    for srv in (js, ts):
        r0 = srv.push(backend, step=0)
        srv.cache(backend).warm(_warm_ids())
        r1 = srv.push(backend, step=8)
        # anchored skip 8 -> 24: deltas 16 and 24 invalidated, no clear
        r2 = srv.push(backend, step=24)
        reports.append([r0, r1, r2])
    assert [_report_key(r) for r in reports[1]] == \
        [_report_key(r) for r in reports[0]]
    kinds = [(r.kind, r.cache_cleared) for r in reports[1]]
    assert kinds == [("full", True), ("delta", False), ("delta", False)]
    assert reports[1][1].invalidated > 0 and reports[1][2].wall_s > 0
    assert ts.pushed_step(backend) == 24
    # rebound, never written into: the old tree is intact
    assert ts.params(backend) is not old
    for a, b in zip(leaves(old), old_leaves):
        assert torch.equal(a, b)
    _assert_same_leaves(tree_to_numpy(ts.params(backend)),
                        tree_to_numpy(ttr.state["params"]))
    _check_after_push(js, ts, backend)


def test_server_push_unanchored_delta_clears_cache(tmp_path):
    jpub, tpub = str(tmp_path / "j"), str(tmp_path / "t")
    jtr, ttr = _trainers("full", jpub, tpub, publish_every=8, full_every=2)
    js, ts = _servers(jpub, tpub)
    reports = []
    for tr, srv in ((jtr, js), (ttr, ts)):
        tr.run(8)                   # publishes: 0 full, 8 delta(0)
        reports.append([srv.push("full", step=8)])
        srv.cache("full").warm(_warm_ids())
        tr.run(24)                  # 16 full, 24 delta(16); delta-8 reaped
        reports[-1].append(srv.push("full", step=24))
    assert [_report_key(r) for r in reports[1]] == \
        [_report_key(r) for r in reports[0]]
    r = reports[1][1]
    assert r.kind == "delta" and r.cache_cleared and r.invalidated == 0
    _check_after_push(js, ts, "full")


def test_server_push_errors(tmp_path):
    _, tcfg = _server_cfgs(None, cache=0)
    srv = tserver.EmbeddingServer(tcfg, device="cpu")
    with pytest.raises(ValueError, match="model_dir"):
        srv.push("full")
    with pytest.raises(FileNotFoundError):
        srv.push("full", ckpt_dir=str(tmp_path / "empty"))
    tck.save(str(tmp_path / "pub"), 3, srv.params("full"), keep_last=0)
    with pytest.raises(FileNotFoundError, match="at step 12345"):
        srv.push("full", step=12345, ckpt_dir=str(tmp_path / "pub"))
    r = srv.push("full", ckpt_dir=str(tmp_path / "pub"))
    assert (r.kind, r.step, r.invalidated, r.cache_cleared) == \
        ("full", 3, 0, False)


@pytest.mark.parametrize("kind", ["full", "hashed"])
def test_hot_cache_invalidation_matches_jax(kind):
    """Touched rows dropped (exact for full, bucket-widened for hashed),
    untouched entries survive, and every served row equals the lookup on
    the NEW params — the same drops as the JAX cache."""
    from repro.nn.embeddings import get_backend as jgb
    from repro.serve.hot_cache import HotRowCache as JCache
    from repro_torch.nn.embeddings import get_backend as tgb
    from repro_torch.serve.hot_cache import HotRowCache as TCache
    jcfg, tcfg = _cfgs(kind)
    jspec, tspec = jcfg.embedding_spec(), tcfg.embedding_spec()
    jparams = jgb(kind).init(jax.random.PRNGKey(0), jspec)
    tparams = _to_torch(jparams)
    jc = JCache(jgb(kind), jspec, jparams, capacity=4096)
    tc = TCache(tgb(kind), tspec, tparams, capacity=4096)
    ids = np.arange(64, dtype=np.int64)
    idx = np.stack([ids % v for v in VOCABS], axis=1)
    jc.lookup(idx)
    tc.lookup(idx)
    before = set(tc._rows)
    touched = np.array([3, 11], np.int64)
    new_np = jax.tree.map(lambda x: np.array(x, copy=True), _np(jparams))
    if kind == "full":
        new_np["table"][touched + int(jspec.offsets[0])] += 0.5
    else:
        m = _m(tspec)
        _, q_off, _ = qr_layout(tspec.vocab_sizes, m)
        new_np["q_table"][touched // m + int(q_off[0])] += 0.5
    jc.set_params(new_np)
    tc.set_params(params_from_numpy(new_np, "cpu"))
    dropped = tc.invalidate(0, touched)
    assert dropped == jc.invalidate(0, touched) > 0
    assert set(tc._rows) == set(jc._rows)
    if kind == "full":
        assert before - set(tc._rows) == {int(t + tspec.offsets[0])
                                          for t in touched}
    assert set(tc._rows) and set(tc._rows) < before
    out = tc.lookup(idx)
    dev = tgb(kind).lookup(tc.params, tspec, torch.from_numpy(
        idx.astype(np.int32))).numpy()
    np.testing.assert_array_equal(out, dev)
    np.testing.assert_array_equal(out, np.asarray(jc.lookup(idx)))


# ---------------------------------------------------------------------------
# replay with pushes
# ---------------------------------------------------------------------------

def test_run_push_cell_row(tmp_path):
    pub = str(tmp_path / "pub")
    _, tcfg = _server_cfgs(None)
    srv = tserver.EmbeddingServer(tcfg, device="cpu")
    tr = tonline.OnlineTrainer(
        srv.recsys_config("full"), _stream(batch=256, drift=8, seed=11),
        tonline.OnlineConfig(publish_dir=pub, publish_every=8),
        device="cpu")
    pushed = []
    tr.run(24, on_publish=lambda rec: pushed.append((rec.step, rec.kind)))
    assert pushed == [(0, "full"), (8, "delta"), (16, "delta"),
                      (24, "delta")]
    row = treplay.run_push_cell(
        srv, "full", treplay.ReplayConfig(n_requests=512, rate_hz=2000.0),
        publish_dir=pub, push_steps=[p.step for p in tr.publishes],
        drift_period=2, warm_batches=8)
    assert row["pushes"] == 3 and row["shed"] == 0
    assert row["push_steps"] == 4 and row["drift_period"] == 2
    for k in ("push_p50_ms", "push_max_ms", "mean_staleness_s", "hit_rate"):
        assert k in row
    assert row["mean_staleness_s"] > 0.0 and srv.pushed_step("full") == 24
    with pytest.raises(ValueError, match="at least one"):
        treplay.run_push_cell(srv, "full", treplay.ReplayConfig(),
                              publish_dir=pub, push_steps=[])


def test_fleet_staggered_push_cache_parity(tmp_path):
    from repro_torch.serve.fleet import ReplicaFleet
    vocabs = (1200, 600, 1800)
    pub = str(tmp_path / "pub")
    _, tcfg = _server_cfgs(pub, vocabs=vocabs)
    fl = ReplicaFleet(tcfg, n_replicas=3, device="cpu")
    stream = _stream(vocabs=vocabs)
    tr = tonline.OnlineTrainer(
        fl.replicas[0].recsys_config("full"), stream,
        tonline.OnlineConfig(publish_dir=pub, publish_every=8,
                             full_every=10), device="cpu")
    tr.run(24)
    shared = fl.replicas[0].params("full")["embedding"]["table"].clone()
    assert [p.kind for p in fl.push_all("full", step=0)] == ["full"] * 3
    fl.warm_caches([stream.batch_at(i)["sparse"] for i in range(6)])
    reports = fl.push_all("full", step=24)
    assert [p.kind for p in reports] == ["delta"] * 3
    assert fl.pushed_steps("full") == [24, 24, 24]
    assert all(r.params("full") is not fl.replicas[0].params("full")
               for r in fl.replicas[1:])
    b = stream.batch_at(999)
    batch = {"dense": b["dense"], "sparse": b["sparse"]}
    want = fl.replicas[0].score("full", batch, use_cache=False)
    for rep in fl.replicas:
        np.testing.assert_array_equal(rep.score("full", batch), want)
        np.testing.assert_array_equal(
            rep.score("full", batch, use_cache=False), want)
    assert not torch.equal(shared,
                           fl.replicas[0].params("full")["embedding"]["table"])
    stats = fl.cache_stats("full")
    assert len(stats) == 3 and all(s["resident_rows"] > 0 for s in stats)


# ---------------------------------------------------------------------------
# the acceptance scenario (tests/test_online.py::test_online_end_to_end)
# ---------------------------------------------------------------------------

def _online_end_to_end(pkg: dict, tmp_path, params=None) -> dict:
    """The JAX package's acceptance scenario, run in ``pkg``'s modules: a
    drifting stream trained live with a straggler that trips a stub
    re-slice at step 17, publishes at 0, 10, ..., 40, then per policy a
    replay of 512 requests with the four later publishes pushed mid-replay
    and cache-on == cache-off scores checked after each push."""
    vocabs = (1200, 600, 1800, 400)
    tag = pkg["tag"]
    pub = str(tmp_path / f"pub-{tag}")
    server = pkg["server"].EmbeddingServer(pkg["server"].ServerConfig(
        vocab_sizes=vocabs, embed_dim=8, n_dense=4, bot_mlp=(16, 8),
        backends=("full",), cache_capacity=4096, model_dir=pub),
        **pkg["server_kw"])
    data = pkg["data"]
    stream = data.CtrStream(data.CtrDataConfig(
        vocab_sizes=vocabs, n_dense=4, batch_size=64, drift_period=10,
        seed=5))
    plan = pkg["elastic"].FaultPlan(slow_steps={14: 1.0, 15: 1.0, 16: 1.0},
                                    base_dt=0.01)
    kw = {} if params is None else dict(params=_to_torch(params))
    tr = pkg["online"].OnlineTrainer(
        server.recsys_config("full"), stream,
        pkg["online"].OnlineConfig(publish_dir=pub, publish_every=10),
        train_cfg=pkg["train_loop"].TrainConfig(checkpoint_every=10_000,
                                                straggler_patience=3),
        **kw)
    init = _np(tr.state["params"])
    reslice_steps = []

    def stub_reslice(state, step):
        # the reference's stub: same params, re-wrapped step_fn
        reslice_steps.append(step)
        return state, plan.wrap_step_fn(tr._step_fn)

    rep = tr.run(40, fault_plan=plan, reslice_fn=stub_reslice,
                 ckpt_dir=str(tmp_path / f"ft-{tag}"))
    probe = stream.batch_at(999)
    probe_batch = {"dense": probe["dense"], "sparse": probe["sparse"]}
    parity_log = []

    def push_and_check(step):
        r = server.push("full", step=step)
        on = server.score("full", probe_batch, use_cache=True)
        off = server.score("full", probe_batch, use_cache=False)
        parity_log.append((step, r.kind, np.array_equal(on, off)))

    rp = pkg["replay"]
    rcfg_data = data.CtrDataConfig(vocab_sizes=vocabs, n_dense=4,
                                   batch_size=256, drift_period=2, seed=23)
    replays = {}
    for policy in ("deadline", "fixed"):
        server.push("full", step=0)
        rstream = data.RequestStream(rcfg_data)
        cfg = rp.ReplayConfig(n_requests=512, rate_hz=2000.0, policy=policy,
                              max_batch=32, max_queue=1024)
        requests = rstream.requests(cfg.n_requests)
        arrivals = data.poisson_arrivals(cfg.rate_hz, cfg.n_requests, seed=3)
        server.cache("full").warm(rstream.id_batches(8))
        score_fn = server.score_fn("full")
        batch, nv = pkg["stack_and_pad"](requests[:1], cfg.max_batch)
        score_fn(batch, n_valid=nv)                  # warm, off-timeline
        span = float(arrivals[-1])
        events = [(span * (k + 1) / 5, lambda s=s: push_and_check(s))
                  for k, s in enumerate([10, 20, 30, 40])]
        replays[policy] = rp.replay(rp.measured_service(score_fn), requests,
                                    arrivals, cfg, events=events)
    return {"init": init, "report": rep, "reslices": reslice_steps,
            "replays": replays, "parity": parity_log}


def test_online_end_to_end_same_as_jax(tmp_path):
    """``tests/test_online.py::test_online_end_to_end`` in both packages:
    the same re-slice, publishes and losses (1e-5), and in the port zero
    dropped in-flight requests through four scheduled pushes a policy and
    cache-on scores equal to cache-off after every push."""
    from repro.data import synthetic_ctr as jdata
    from repro.serve import replay as jreplay
    from repro.serve.router import stack_and_pad as jpad
    from repro_torch.data import synthetic_ctr as tdata
    from repro_torch.serve.router import stack_and_pad as tpad

    jax_pkg = dict(tag="j", server=jserver, server_kw={}, data=jdata,
                   elastic=jelastic, online=jonline, train_loop=jtl,
                   replay=jreplay, stack_and_pad=jpad)
    torch_pkg = dict(tag="t", server=tserver, server_kw=dict(device="cpu"),
                     data=tdata, elastic=telastic, online=tonline,
                     train_loop=ttl, replay=treplay, stack_and_pad=tpad)
    j = _online_end_to_end(jax_pkg, tmp_path)
    t = _online_end_to_end(torch_pkg, tmp_path,
                           params=j["init"])
    for run in (j, t):
        rep = run["report"]
        assert rep.reslices == 1 and run["reslices"] == [17]
        assert [p.step for p in rep.publishes] == [0, 10, 20, 30, 40]
        for policy, r in run["replays"].items():
            # zero dropped in-flight requests: everything admitted
            # completes
            assert r.shed == 0 and r.completed == 512, policy
            assert r.pushes == 4 and r.mean_staleness_s > 0.0, policy
        assert len(run["parity"]) == 8      # 4 checked pushes x 2 policies
        assert {k for _, k, _ in run["parity"]} == {"delta"}
        assert all(ok for _, _, ok in run["parity"]), run["parity"]
    jrep, trep = j["report"], t["report"]
    assert [(p.step, p.kind, p.n_touched) for p in trep.publishes] == \
        [(p.step, p.kind, p.n_touched) for p in jrep.publishes]
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=0,
                               atol=LOSS_TOL)
