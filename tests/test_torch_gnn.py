"""The port's GatedGCN and graph data against the JAX package, on the CPU.

GatedGCN on the smoke config of every ``GNN_SHAPES`` cell (Cora-like full
graph, a sampled minibatch with ``label_mask``, a padded full-batch graph,
and batched molecules with the atom-type embedding, ``node_mask`` and the
graph readout): logits, loss and every gradient leaf within rtol = atol =
1e-5 in f32, with params from ``repro``'s init; ``tests/test_gnn.py``'s
dense-adjacency and padded-edge cases on the port; ``CsrGraph``,
``NeighborSampler.sample`` and ``molecule_batch`` equal to the JAX
package's arrays bit for bit; and ``examples/train_gnn.py``'s two runs,
each port step taken from the JAX run's state before it.  On the CPU no
kernel launches; under a one-rank mesh the model runs its data- and
edge-parallel paths and matches the run without one
(``tests/test_torch_dist_lm_ranks.py`` holds four ranks to the JAX
package).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.data import graphs as jgraphs
from repro.models import gatedgcn as jgcn
from repro.train import optimizer as jopt
from repro.train import train_loop as jtl
from repro_torch import kernels as tk
from repro_torch.configs import GNN_SHAPES, all_arch_ids
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.data import graphs as tgraphs
from repro_torch.dist import api as dist
from repro_torch.models import gatedgcn as tgcn
from repro_torch.nn.core import dense_apply, mlp_apply
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


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _tb(batch: dict) -> dict:
    return {k: _t(v) for k, v in batch.items()}


def _params(jcfg, seed: int = 0):
    jp = jgcn.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _smoke_batch(shape: str, cfg, rs) -> dict:
    """A small batch of the cell's layout, from the port's data modules
    (equal to the JAX package's, ``test_graph_data_matches_jax``)."""
    if shape == "molecule":
        return tgraphs.molecule_batch(6, 9, 17, seed=3)
    if shape == "minibatch_lg":
        g = tgraphs.CsrGraph(tgraphs.GraphSpec(n_nodes=300, n_edges=2000,
                                               d_feat=cfg.d_feat,
                                               n_classes=cfg.n_classes))
        return tgraphs.NeighborSampler(g, tgraphs.SamplerConfig(
            batch_nodes=8, fanouts=(4, 3))).sample(2)
    g = tgraphs.CsrGraph(tgraphs.GraphSpec(n_nodes=40, n_edges=150,
                                           d_feat=cfg.d_feat,
                                           n_classes=cfg.n_classes))
    b = g.full_batch()
    if shape == "ogb_products":          # -1-padded edges
        pad = -np.ones((1, 23, 2), np.int32)
        b["edges"] = np.concatenate([b["edges"], pad], 1)
    return b


def _port_loss_grads(tp, tcfg, batch):
    flat, td = jax.tree_util.tree_flatten(
        tp, is_leaf=lambda x: isinstance(x, torch.Tensor))
    xs = [x.detach().requires_grad_(True) for x in flat]
    loss = tgcn.loss_fn(jax.tree_util.tree_unflatten(td, xs), tcfg,
                        _tb(batch))[0]
    gs = torch.autograd.grad(loss, xs, allow_unused=True)
    return float(loss.detach()), [np.zeros(tuple(x.shape), np.float32)
                                  if g is None else g.numpy()
                                  for x, g in zip(xs, gs)]


@pytest.mark.parametrize("shape", list(GNN_SHAPES))
def test_gatedgcn_matches_jax(shape):
    jcfg = j_get_arch("gatedgcn").make_config("smoke", shape=shape)
    tcfg = t_get_arch("gatedgcn").make_config("smoke", shape=shape)
    jp, tp = _params(jcfg)
    batch = _smoke_batch(shape, tcfg, np.random.RandomState(0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tk.reset_launches()
    want = jgcn.forward(jp, jcfg, jbatch)
    with torch.no_grad():
        got = tgcn.forward(tp, tcfg, _tb(batch))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jloss, jg = jax.value_and_grad(
        lambda p: jgcn.loss_fn(p, jcfg, jbatch)[0])(jp)
    tloss, tg = _port_loss_grads(tp, tcfg, batch)
    np.testing.assert_allclose(tloss, float(jloss), **TOL)
    named = jax.tree_util.tree_leaves_with_path(jg)
    assert len(named) == len(tg)
    for (path, w), g in zip(named, tg):
        np.testing.assert_allclose(g, np.asarray(w), **TOL,
                                   err_msg=jax.tree_util.keystr(path))
    assert all(v == 0 for v in tk.launch_counts().values())


def test_node_loss_without_label_mask_and_graph_mean_readout():
    """The node task without ``label_mask`` (mean over every node) and the
    graph readout without ``node_mask`` (plain mean over nodes)."""
    for shape, drop in (("full_graph_sm", "label_mask"),
                        ("molecule", "node_mask")):
        jcfg = j_get_arch("gatedgcn").make_config("smoke", shape=shape)
        tcfg = t_get_arch("gatedgcn").make_config("smoke", shape=shape)
        jp, tp = _params(jcfg, seed=1)
        batch = _smoke_batch(shape, tcfg, None)
        batch.pop(drop, None)
        jloss = jgcn.loss_fn(jp, jcfg, {k: jnp.asarray(v)
                                        for k, v in batch.items()})[0]
        with torch.no_grad():
            tloss = tgcn.loss_fn(tp, tcfg, _tb(batch))[0]
        np.testing.assert_allclose(float(tloss), float(jloss), **TOL)


def test_segment_mp_equals_dense_adjacency():
    """tests/test_gnn.py's case on the port: Σ_{j→i} η_ij ⊙ B h_j by
    ``index_add_`` == the dense numpy computation of one layer."""
    rs = np.random.RandomState(0)
    n, e, h = 12, 40, 8
    cfg = tgcn.GatedGCNConfig(name="t", n_layers=1, d_hidden=h, d_feat=h,
                              n_classes=3)
    jp, params = _params(jgcn.GatedGCNConfig(name="t", n_layers=1,
                                             d_hidden=h, d_feat=h,
                                             n_classes=3))
    src = rs.randint(0, n, e)
    dst = rs.randint(0, n, e)
    x = rs.randn(1, n, h).astype(np.float32)
    batch = {"nodes": _t(x),
             "edges": _t(np.stack([src, dst], -1)[None].astype(np.int32)),
             "labels": torch.zeros((1, n), dtype=torch.int32)}
    with torch.no_grad():
        out = tgcn.forward(params, cfg, batch).numpy()
        W = params["layers"][0]
        h0 = dense_apply(params["embed"], _t(x[0]))
        e0 = dense_apply(params["edge_embed"], torch.ones((1, 1))).expand(
            e, h)
        hi, hj = h0[src], h0[dst]
        e_hat = (dense_apply(W["C"], e0) + dense_apply(W["D"], hj)
                 + dense_apply(W["E"], hi))
        sig = torch.sigmoid(e_hat).numpy()
        denom = np.zeros((n, h), np.float32)
        np.add.at(denom, dst, sig)
        eta = sig / (denom[dst] + 1e-6)
        msg = eta * dense_apply(W["B"], hi).numpy()
        agg = np.zeros((n, h), np.float32)
        np.add.at(agg, dst, msg)
        pre = dense_apply(W["A"], h0).numpy() + agg
        bn = (pre - pre.mean(0, keepdims=True)) / np.sqrt(
            pre.var(0, keepdims=True) + 1e-5)
        h1 = h0.numpy() + np.maximum(bn, 0)
        want = mlp_apply(params["readout"], _t(h1)).numpy()
    np.testing.assert_allclose(out[0], want, rtol=2e-4, atol=2e-4)


def test_padded_edges_do_not_contribute():
    cfg = tgcn.GatedGCNConfig(name="t", n_layers=2, d_hidden=8, d_feat=4,
                              n_classes=3)
    _, params = _params(jgcn.GatedGCNConfig(name="t", n_layers=2,
                                            d_hidden=8, d_feat=4,
                                            n_classes=3))
    rs = np.random.RandomState(1)
    x = _t(rs.randn(1, 10, 4).astype(np.float32))
    e_real = rs.randint(0, 10, (1, 20, 2))
    pad = -np.ones((1, 12, 2), np.int64)
    labels = torch.zeros((1, 10), dtype=torch.int32)
    with torch.no_grad():
        o1 = tgcn.forward(params, cfg, {"nodes": x, "labels": labels,
                                        "edges": _t(e_real.astype(
                                            np.int32))})
        o2 = tgcn.forward(params, cfg, {"nodes": x, "labels": labels,
                                        "edges": _t(np.concatenate(
                                            [e_real, pad], 1).astype(
                                            np.int32))})
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), rtol=1e-4, atol=1e-4)


def test_batched_graphs_equal_one_at_a_time():
    """The B graphs run at once (node ids offset by graph, per-graph
    BatchNorm statistics) as the JAX package's map over graphs: each
    graph's logits equal that graph run alone."""
    cfg = t_get_arch("gatedgcn").make_config("smoke", shape="molecule")
    _, tp = _params(j_get_arch("gatedgcn").make_config("smoke",
                                                       shape="molecule"))
    b = tgraphs.molecule_batch(5, 9, 17, seed=4)
    with torch.no_grad():
        whole = tgcn.forward(tp, cfg, _tb(b)).numpy()
        for i in range(5):
            one = tgcn.forward(tp, cfg, _tb({k: v[i:i + 1]
                                            for k, v in b.items()}))
            np.testing.assert_allclose(one.numpy()[0], whole[i], **TOL)


# ---------------------------------------------------------------------------
# graph data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    dict(n_nodes=300, n_edges=1500, d_feat=6),
    dict(n_nodes=2708, n_edges=10556, d_feat=33, n_classes=7, seed=2)])
def test_graph_data_matches_jax(spec):
    jg = jgraphs.CsrGraph(jgraphs.GraphSpec(**spec))
    tg = tgraphs.CsrGraph(tgraphs.GraphSpec(**spec))
    for k in ("src", "dst", "indptr", "features", "labels"):
        a, b = getattr(jg, k), getattr(tg, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for k, v in jg.full_batch().items():
        np.testing.assert_array_equal(tg.full_batch()[k], v)
    for fan in ((4, 3), (15, 10)):
        js = jgraphs.NeighborSampler(jg, jgraphs.SamplerConfig(
            batch_nodes=8, fanouts=fan))
        ts = tgraphs.NeighborSampler(tg, tgraphs.SamplerConfig(
            batch_nodes=8, fanouts=fan))
        assert (ts.max_nodes, ts.max_edges) == (js.max_nodes, js.max_edges)
        for step in (0, 3):
            a, b = js.sample(step), ts.sample(step)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                np.testing.assert_array_equal(b[k], a[k])


@pytest.mark.parametrize("kw", [dict(batch=16, n_nodes=10, n_edges=20,
                                     seed=1),
                                dict(batch=128, n_nodes=30, n_edges=64,
                                     step=7)])
def test_molecule_batch_matches_jax(kw):
    a, b = jgraphs.molecule_batch(**kw), tgraphs.molecule_batch(**kw)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(b[k], a[k])


def test_configs_and_registry_match_jax():
    from repro.configs import all_arch_ids as j_all_arch_ids
    from repro.configs.registry import ARCH_IDS as J_ARCH_IDS
    from repro.configs.registry import GNN_SHAPES as J_GNN_SHAPES
    from repro_torch.configs import ARCH_IDS
    assert all_arch_ids() == j_all_arch_ids()
    assert ARCH_IDS == J_ARCH_IDS and GNN_SHAPES == J_GNN_SHAPES
    for arch in ARCH_IDS:
        assert t_get_arch(arch).kind == j_get_arch(arch).kind
    for variant in ("full", "smoke"):
        for shape in GNN_SHAPES:
            j = j_get_arch("gatedgcn").make_config(variant, shape=shape)
            t = t_get_arch("gatedgcn").make_config(variant, shape=shape)
            jd = {k: v for k, v in vars(j).items() if k != "compute_dtype"}
            td = {k: v for k, v in vars(t).items() if k != "compute_dtype"}
            assert td == jd
            assert t.compute_dtype == torch.float32


@pytest.fixture(scope="module")
def one_rank_mesh(tmp_path_factory):
    """A world of this one process (gloo) and the (1, 1) ("data",
    "model") mesh on it."""
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


@pytest.mark.parametrize("shape", ("full_graph_sm", "molecule",
                                   "edge_parallel"))
def test_mesh_guard_raises(one_rank_mesh, shape):
    """The mesh guard: under an active context ``forward`` and
    ``loss_fn`` run (data-parallel over graphs, or edge-parallel for one
    graph of at least ``EDGE_PARALLEL_MIN`` edges) and raise nothing; on a
    one-rank mesh they match the calls without a context, gradients
    included."""
    cell = "full_graph_sm" if shape == "edge_parallel" else shape
    jcfg = j_get_arch("gatedgcn").make_config("smoke", shape=cell)
    cfg = t_get_arch("gatedgcn").make_config("smoke", shape=cell)
    _, tp = _params(jcfg)
    batch = _smoke_batch(cell, cfg, None)
    if shape == "edge_parallel":
        rs = np.random.RandomState(0)
        n = batch["nodes"].shape[1]
        edges = rs.randint(0, n, (1, tgcn.EDGE_PARALLEL_MIN + 8, 2))
        edges[0, -8:] = -1
        batch = dict(batch, edges=edges.astype(np.int32))
    runs = []
    for ctx in (None, one_rank_mesh):
        with dist.use(ctx) if ctx else contextlib.nullcontext():
            with torch.no_grad():
                logits = tgcn.forward(tp, cfg, _tb(batch))
            loss, grads = _port_loss_grads(tp, cfg, batch)
        runs.append((logits, loss, grads))
    (l0, s0, g0), (l1, s1, g1) = runs
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), **TOL)
    np.testing.assert_allclose(s1, s0, **TOL)
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(b, a, **TOL)


# ---------------------------------------------------------------------------
# examples/train_gnn.py in both packages
# ---------------------------------------------------------------------------

#: leaves left out of the update reading: the A biases feed only a
#: BatchNorm over the nodes, which subtracts them again, so their gradient
#: is zero up to rounding, and adam turns that rounding into steps of ±lr
#: in either package
DEGENERATE = "['A']['b']"


def _step_update_err(old, new_port, new_jax) -> dict:
    """Per param leaf, |Δport - Δjax| / |Δjax| of one step (norms over the
    leaf), each Δ the step's change from the same ``old`` params."""
    names = jax.tree.leaves(jax.tree_util.tree_map_with_path(
        lambda path, _: jax.tree_util.keystr(path), old))
    out = {}
    for name, o, t, j in zip(names, jax.tree.leaves(old),
                             jax.tree.leaves(new_port),
                             jax.tree.leaves(new_jax)):
        o = np.asarray(o, np.float64)
        want = np.asarray(j, np.float64) - o
        w = np.linalg.norm(want)
        if w > 0 and not name.endswith(DEGENERATE):
            out[name] = np.linalg.norm(np.asarray(t, np.float64) - o
                                       - want) / w
    return out


def _example(run: str):
    """(JAX config, port config, batch_at, JAX batch_at) of the example's
    run."""
    if run == "full_graph":
        spec = dict(n_nodes=600, n_edges=3000, d_feat=16, n_classes=6)
        cfg = dict(name="fg", n_layers=4, d_hidden=32, d_feat=16,
                   n_classes=6)
        jb = jgraphs.CsrGraph(jgraphs.GraphSpec(**spec)).full_batch()
        tb = tgraphs.CsrGraph(tgraphs.GraphSpec(**spec)).full_batch()
        return (jgcn.GatedGCNConfig(**cfg), tgcn.GatedGCNConfig(**cfg),
                lambda s: tb, lambda s: jb)
    spec = dict(n_nodes=5000, n_edges=40000, d_feat=16, n_classes=6)
    sc = dict(batch_nodes=64, fanouts=(10, 5))
    cfg = dict(name="mb", n_layers=3, d_hidden=32, d_feat=16, n_classes=6)
    js = jgraphs.NeighborSampler(jgraphs.CsrGraph(jgraphs.GraphSpec(**spec)),
                                 jgraphs.SamplerConfig(**sc))
    ts = tgraphs.NeighborSampler(tgraphs.CsrGraph(tgraphs.GraphSpec(**spec)),
                                 tgraphs.SamplerConfig(**sc))
    return (jgcn.GatedGCNConfig(**cfg), tgcn.GatedGCNConfig(**cfg),
            ts.sample, js.sample)


@pytest.mark.parametrize("run", ("full_graph", "sampled_minibatch"))
def test_train_gnn_example(run):
    """60 adam steps (lr 3e-3) of each of the example's runs: each port
    step from the JAX run's state before it, its loss within 1e-5 and each
    param leaf's update (``DEGENERATE`` aside) within 1e-4 of its norm at
    the median over the steps; the loss falls.  (The runs drive the loss
    to ~1e-2, where adam's steps grow from rounding-level gradients: a
    step's reading is kept as the median's, not gated one by one.)"""
    jcfg, tcfg, batch_at, jbatch_at = _example(run)
    jp = jgcn.init_params(jax.random.PRNGKey(0), jcfg)
    opt = dict(kind="adam", lr=3e-3)
    jo = jopt.make_optimizer(jopt.OptimizerConfig(**opt))
    to = topt.make_optimizer(topt.OptimizerConfig(**opt))
    jc = jtl.TrainConfig(checkpoint_every=10 ** 9)
    tc = ttl.TrainConfig(checkpoint_every=10 ** 9)
    jstep = jtl.build_train_step(lambda p, b: jgcn.loss_fn(p, jcfg, b), jo,
                                 jc)
    tstep = ttl.build_train_step(lambda p, b: tgcn.loss_fn(p, tcfg, b), to,
                                 tc)
    before = []

    def recorded(state, batch):
        before.append(jax.tree.map(np.asarray, state))
        return jstep(state, batch)

    n = 60
    jrep = jtl.run(jtl.init_state(jp, jo, jc), recorded, jbatch_at, n, jc)
    assert jrep.steps_done == len(before) == n
    after = before[1:] + [jax.tree.map(np.asarray, jrep.state)]
    diffs, per = [], {}
    for k, (old, new) in enumerate(zip(before, after)):
        got, m = tstep(params_from_numpy(old, "cpu"), _tb(batch_at(k)))
        diffs.append(abs(float(m["loss"]) - jrep.losses[k]))
        for name, r in _step_update_err(old["params"], tree_to_numpy(
                got["params"]), new["params"]).items():
            per.setdefault(name, []).append(r)
    rel = {name: float(np.median(r)) for name, r in per.items()}
    print(f"{run}: JAX loss {jrep.losses[0]:.4f} -> {jrep.losses[-1]:.4f}; "
          f"max step loss diff {max(diffs):.3e}, update error "
          f"{max(rel.values()):.3e}")
    assert max(diffs) <= 1e-5, (max(diffs), int(np.argmax(diffs)))
    assert max(rel.values()) <= 1e-4, rel
    assert jrep.losses[-1] < jrep.losses[0]
