"""The port's spans (``repro_torch.tracing``), on the CPU.

* with no profiler, ``span`` is the shared no-op and records nothing, and
  ``EmbeddingServer.score`` gives the same scores, bit for bit, with a
  profiler running and without;
* under ``torch.profiler``, one ``score`` records ``server.score`` with
  exactly the children ``server.copy_in``, ``server.model`` and
  ``server.copy_out`` (and the DLRM's ``model.*`` under ``server.model``),
  nested in time, one ``request`` a call, with the bytes copied and the
  rows scored; ``step_fn`` records ``train.step`` with a forward and a
  backward a microbatch, the guard and the update;
* each span lies on the profiler's host timeline under its name, not as
  a user annotation, at the in-memory record's interval (within 0.2 ms);
* the ring keeps its capacity of the newest records, and a span left by
  an exception is recorded and closed.
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import kernels as tk
from repro_torch import tracing
from repro_torch.models import recsys as trec
from repro_torch.serve import server as tserver
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as ttl

VOCABS = (300, 120, 500, 40)
N_DENSE = 5
SERVE = ("server.copy_in", "server.model", "server.copy_out")
MODEL = ("model.bot_mlp", "model.interaction", "model.top_mlp")
#: a profiler event's interval may stick out of its record's by this much
#: (the profiler's clock is the Unix epoch's, converted)
SLACK_NS = 200_000


@pytest.fixture(autouse=True)
def _no_launches():
    """Every test here runs on the CPU: no kernel may be launched."""
    tk.reset_launches()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    assert all(k == 0 for k in tk.launch_counts().values())


def _server(backend: str):
    cfg = tserver.ServerConfig(
        vocab_sizes=VOCABS, embed_dim=8, n_dense=N_DENSE, bot_mlp=(16, 8),
        top_mlp=(16, 1), backends=(backend,), robe_compression=4,
        robe_block=4, cache_capacity=64 if backend == "full" else 0)
    return tserver.EmbeddingServer(cfg, device="cpu")


def _batch(rows: int, seed: int = 0, labels: bool = False) -> dict:
    rs = np.random.RandomState(seed)
    b = {"dense": rs.rand(rows, N_DENSE).astype(np.float32),
         "sparse": np.stack([rs.randint(0, v, rows) for v in VOCABS],
                            axis=1).astype(np.int32)}
    if labels:
        b["label"] = (rs.rand(rows) < 0.5).astype(np.float32)
    return b


def _new(before: int) -> list:
    """The records appended since ``before`` records were kept (the ring
    does not fill in these tests)."""
    return tracing.records()[before:]


def _profiled(fn):
    before = len(tracing.records())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _new(before), prof


def _children(recs: list, parent) -> list:
    return sorted((r for r in recs if r.parent == parent.id),
                  key=lambda r: r.start_ns)


def _inside(child, parent) -> bool:
    return (parent.start_ns <= child.start_ns <= child.end_ns
            <= parent.end_ns)


@pytest.mark.parametrize("backend", ["robe", "full"])
def test_off_records_nothing_and_scores_alike(backend):
    srv = _server(backend)
    b = _batch(32)
    assert tracing.span("a") is tracing.span("b")
    with tracing.span("server.score") as s:
        s.add("samples", 3)
    before = len(tracing.records())
    off = srv.score(backend, b)
    assert len(tracing.records()) == before
    on, recs, _ = _profiled(lambda: srv.score(backend, b))
    assert recs and np.array_equal(off, on)


@pytest.mark.parametrize("backend", ["robe", "full"])
def test_score_records_its_layers(backend):
    srv = _server(backend)
    b = _batch(24, seed=1)
    (out, out2), recs, _ = _profiled(
        lambda: (srv.score(backend, b, n_valid=20),
                 srv.score(backend, _batch(16, seed=2))))
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["server.score"] * 2
    assert roots[0].request != roots[1].request
    for root, rows in zip(roots, (24, 16)):
        assert root.request == root.id
        assert root.counts == {"samples": rows}
        kids = _children(recs, root)
        assert tuple(k.name for k in kids) == SERVE
        assert all(_inside(k, root) for k in kids)
        mine = [r for r in recs if r.request == root.id]
        assert {r.name for r in mine} == {"server.score", *SERVE, *MODEL}
        model = _children(recs, kids[1])
        assert tuple(m.name for m in model) == MODEL
        assert all(_inside(m, kids[1]) for m in model)
    # the bytes moved: dense and ids, or dense and the cache's rows
    width = len(VOCABS) * (8 * 4 if backend == "full" else 4)
    copy_in = _children(recs, roots[0])[0]
    assert copy_in.counts == {"h2d_bytes": 24 * (N_DENSE * 4 + width)}
    assert all(not k.counts for k in _children(recs, roots[0])[1:])
    assert out.shape == (20,) and out2.shape == (16,)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_step_records_its_layers(grad_accum):
    cfg = trec.RecsysConfig(name="t", arch="dlrm", vocab_sizes=VOCABS,
                            embed_dim=8, n_dense=N_DENSE, bot_mlp=(16, 8),
                            top_mlp=(16, 1), embedding="robe",
                            robe_size=512, robe_block=4)
    gen = torch.Generator().manual_seed(0)
    params = trec.init_params(cfg, gen, "cpu")
    opt = topt.make_optimizer(topt.OptimizerConfig(kind="sgd"))
    tc = ttl.TrainConfig(grad_accum=grad_accum)
    step_fn = ttl.build_train_step(lambda p, b: trec.loss_fn(p, cfg, b), opt,
                                   tc)
    state = ttl.init_state(params, opt, tc)
    batch = {k: torch.as_tensor(v) for k, v in
             _batch(16, labels=True).items()}
    (state, metrics), recs, _ = _profiled(lambda: step_fn(state, batch))
    assert float(metrics["finite"]) == 1.0
    root, = [r for r in recs if r.parent is None]
    assert root.name == "train.step" and root.counts == {"samples": 16}
    kids = _children(recs, root)
    assert [k.name for k in kids] == \
        ["train.forward", "train.backward"] * grad_accum + \
        ["train.guard", "train.update"]
    assert all(_inside(k, root) and k.request == root.id for k in kids)
    # the DLRM's forward spans, one set a microbatch, under train.forward
    fwd = [r for r in recs if r.name.startswith("model.")]
    assert len(fwd) == 3 * grad_accum
    assert {r.parent for r in fwd} == \
        {k.id for k in kids if k.name == "train.forward"}


def test_spans_lie_on_the_profiler_timeline():
    srv = _server("robe")
    _, recs, prof = _profiled(lambda: [srv.score("robe", _batch(8, seed=s))
                                       for s in range(3)])
    t0 = prof.profiler.kineto_results.trace_start_ns()
    names = {r.name for r in recs}
    assert names == {"server.score", *SERVE, *MODEL}
    events = collections.defaultdict(list)
    for e in prof.events():
        if e.name in names:
            events[e.name].append(e)
    for name in names:
        mine = sorted((r for r in recs if r.name == name),
                      key=lambda r: r.start_ns)
        evts = sorted(events[name], key=lambda e: e.time_range.start)
        assert len(evts) == len(mine) == 3, name
        for r, e in zip(mine, evts):
            assert e.is_user_annotation is False
            start = t0 + e.time_range.start * 1e3
            end = t0 + e.time_range.end * 1e3
            assert r.start_ns - SLACK_NS <= start <= end \
                <= r.end_ns + SLACK_NS, name


def test_ring_keeps_its_capacity(monkeypatch):
    monkeypatch.setattr(tracing, "_RING", collections.deque(maxlen=5))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(12):
            with tracing.span(f"s{i}") as s:
                s.add("n", i)
                s.add("n", 1)
    recs = tracing.records()
    assert [r.name for r in recs] == [f"s{i}" for i in range(7, 12)]
    assert [r.counts["n"] for r in recs] == list(range(8, 13))
    assert tracing.CAPACITY >= 16 * 7_000


def test_a_span_left_by_an_exception_is_closed():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with tracing.span("outer"):
                with tracing.span("inner"):
                    raise ValueError("out")
        with tracing.span("next"):
            pass
    inner, outer, nxt = tracing.records()[-3:]
    assert (inner.name, outer.name, nxt.name) == ("inner", "outer", "next")
    assert inner.parent == outer.id and outer.parent is None
    assert nxt.parent is None and nxt.request == nxt.id
