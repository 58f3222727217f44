"""The port's checkpoints and fault-tolerant restarts against the JAX
package's, on the CPU.

* the on-disk format: each package restores the other's checkpoints,
  full and delta chains, leaf for leaf and bit for bit (dlrm-rm2 smoke
  robe and qrobe adagrad states, a tree with ``None`` leaves, bf16);
* the JAX package's checkpoint cases (``tests/test_online.py``'s delta and
  ``restore_latest`` cases, ``tests/test_elastic.py``'s fault paths,
  ``tests/test_system.py``'s fault-tolerant run) on the port; faults are
  injected by ``_Faults`` below (the port has no ``FaultPlan`` yet);
* ``train_loop.run`` with ``ckpt_dir`` against the JAX package's ``run``
  under the same injected raise and NaN batch: the same ``restarts``,
  ``nan_events`` and ``steps_done``, and losses within 1e-5.

Every test runs on the CPU: no kernel may be launched.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.data.synthetic_ctr import CtrDataConfig, CtrStream
from repro.models import recsys as jrec
from repro.train import checkpoint as jck
from repro.train import optimizer as jopt
from repro.train import train_loop as jtl
from repro_torch import kernels as tk
from repro_torch import tree as ttree
from repro_torch.configs.registry import get_arch as t_get_arch
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.models import recsys as trec
from repro_torch.train import checkpoint as ck
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as ttl


@pytest.fixture(autouse=True)
def _no_launches():
    tk.reset_launches()
    yield
    assert all(n == 0 for n in tk.launch_counts().values())


def _t0():
    return {"a": torch.arange(6, dtype=torch.float32),
            "b": torch.ones((2, 3), dtype=torch.float32),
            "c": torch.zeros(4, dtype=torch.int8)}


def _equal_trees(got, want) -> None:
    """Same structure, and every leaf the same tensor bit for bit (numpy
    leaves of ``want`` compared as arrays)."""
    gl, wl = ttree.leaves(got), ttree.leaves_up_to(got, want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        if g is None or w is None:
            assert g is None and w is None
            continue
        assert isinstance(g, torch.Tensor)
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and g.device == w.device
            assert torch.equal(g, w)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# the format
# ---------------------------------------------------------------------------

def test_save_and_restore_round_trip(tmp_path):
    d = str(tmp_path)
    tree = {"params": {"w": torch.randn(3, 4), "codes": torch.arange(
        -5, 5, dtype=torch.int8)}, "step": torch.tensor(7, dtype=torch.int32),
        "h": torch.randn(5).to(torch.bfloat16)}
    path = ck.save(d, 7, tree, extra={"note": "x"})
    assert os.path.basename(path) == "step-0000000007"
    man = json.load(open(os.path.join(path, "manifest.json")))
    assert sorted(man) == ["extra", "leaves", "n_leaves", "step", "treedef"]
    assert man["step"] == 7 and man["n_leaves"] == 4
    assert man["extra"] == {"note": "x"}
    # leaves in sorted key order: h, params/codes, params/w, step
    assert [m["dtype"] for m in man["leaves"]] == [
        "bfloat16", "int8", "float32", "int32"]
    assert [m["shape"] for m in man["leaves"]] == [[5], [10], [3, 4], []]
    assert all(sorted(m) == ["crc32", "dtype", "key", "shape"]
               for m in man["leaves"])
    template = ttree.tree_map(torch.zeros_like, tree)
    got, gman = ck.restore_latest(d, template)
    assert gman["step"] == 7
    _equal_trees(got, tree)
    assert got["step"].dim() == 0 and got["step"].dtype == torch.int32


def test_restored_leaves_take_the_template_dtype(tmp_path):
    d = str(tmp_path)
    ck.save(d, 1, {"a": torch.arange(4, dtype=torch.float32)})
    got, _ = ck.restore_latest(d, {"a": torch.zeros(4, dtype=torch.float64)})
    assert got["a"].dtype == torch.float64
    assert torch.equal(got["a"], torch.arange(4, dtype=torch.float64))
    # a template of another shape is not this checkpoint's tree
    assert ck.restore_latest(d, {"a": torch.zeros(5)}) is None


def test_none_leaves_are_skipped_and_put_back(tmp_path):
    d = str(tmp_path)
    tree = {"a": torch.arange(3.0), "b": None,
            "c": [None, torch.ones(2, dtype=torch.int32)]}
    path = ck.save(d, 1, tree)
    man = json.load(open(os.path.join(path, "manifest.json")))
    assert man["n_leaves"] == 2
    assert [m["key"] for m in man["leaves"]] == ["leaf_0", "leaf_1"]
    got, _ = ck.restore_latest(d, ttree.tree_map(
        lambda x: None if x is None else torch.zeros_like(x), tree))
    assert got["b"] is None and got["c"][0] is None
    _equal_trees(got, tree)


def test_corrupted_checkpoint_falls_back_to_the_previous(tmp_path):
    d = str(tmp_path)
    t0 = _t0()
    ck.save(d, 1, t0)
    ck.save(d, 2, dict(t0, a=t0["a"] + 1))
    man_path = os.path.join(d, f"step-{2:010d}", "manifest.json")
    man = json.load(open(man_path))
    man["leaves"][0]["crc32"] ^= 1
    json.dump(man, open(man_path, "w"))
    got, man = ck.restore_latest(d, _t0())
    assert man["step"] == 1
    _equal_trees(got, t0)
    assert ck.restore_latest(d, _t0(), step=2) is None


def test_keep_last_gc(tmp_path):
    d = str(tmp_path)
    for s in range(5):
        ck.save(d, s, _t0(), keep_last=2)
    assert sorted(os.listdir(d)) == [f"step-{3:010d}", f"step-{4:010d}"]


def test_shardings_wait_for_distribution(tmp_path):
    """Restoring with ``shardings`` cuts each global leaf to the rank's
    shard (here rank (1, 0) of a (2, 2) mesh, whose coordinates are all a
    cut reads), a ``None`` sharding keeps the leaf whole, and
    ``restore_onto`` prunes the specs against the checkpoint's global
    shapes first (6 rows do not divide 4 ranks: replicated)."""
    import types

    from repro_torch.dist import api as dist
    from repro_torch.dist.api import P
    d = str(tmp_path)
    ck.save(d, 1, _t0())
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 2, "model": 2},
                                 coords={"data": 1, "model": 0})
    ctx = dist.DistContext(mesh=mesh, rules=dist.default_rules())
    shardings = {"a": dist.Sharding(ctx, P("data")),
                 "b": dist.Sharding(ctx, P(None, None)), "c": None}
    for fn in (ck.restore_latest, ck.restore_delta):
        got, _ = fn(d, _t0(), shardings=shardings)
        assert torch.equal(got["a"], torch.arange(3, 6, dtype=torch.float32))
        assert torch.equal(got["b"], _t0()["b"])
        assert torch.equal(got["c"], _t0()["c"])
        with pytest.raises(ValueError, match="congruent"):
            fn(d, _t0(), shardings={"a": None})
    got, _ = ck.restore_onto(d, _t0(), ctx, {"a": P(("data", "model")),
                                             "b": P("model"), "c": P()})
    assert torch.equal(got["a"], _t0()["a"])          # 6 % 4: replicated
    assert torch.equal(got["b"], _t0()["b"][:1])      # 2 % 2: model 0


def test_async_save_snapshots_before_returning(tmp_path):
    """The state may be updated in place by the next step: what is written
    is the tree as it was when ``save`` returned."""
    d = str(tmp_path)
    tree = {"a": torch.zeros(1000)}
    saver = ck.AsyncCheckpointer(d)
    saver.save(3, tree)
    tree["a"].add_(1.0)
    saver.wait()
    got, _ = ck.restore_latest(d, tree)
    assert not got["a"].any()


# ---------------------------------------------------------------------------
# tests/test_online.py's delta and restore_latest cases on the port
# ---------------------------------------------------------------------------

def test_save_delta_stores_only_changed_leaves(tmp_path):
    d = str(tmp_path)
    t0 = _t0()
    t1 = dict(t0, a=t0["a"] + 1.0)
    ck.save(d, 0, t0, keep_last=0)
    path = ck.save_delta(d, 10, t1, t0, 0, touched={0: [3, 1]})
    man = json.load(open(os.path.join(path, "manifest.json")))
    # leaves flatten in key order a, b, c: only 'a' changed
    assert [m["changed"] for m in man["leaves"]] == [True, False, False]
    stored = np.load(os.path.join(path, "arrays.npz"))
    assert set(stored.files) == {"leaf_0"}
    assert man["touched"] == {"0": [1, 3]}          # sorted, int
    tree, rman = ck.restore_delta(d, _t0())
    assert rman["step"] == 10 and rman["base_full_step"] == 0
    _equal_trees(tree, t1)


def test_save_delta_threshold_suppresses_small_float_changes(tmp_path):
    d = str(tmp_path)
    t0 = _t0()
    t1 = dict(t0, a=t0["a"] + 1e-6, b=t0["b"] + 1.0)
    ck.save(d, 0, t0, keep_last=0)
    path = ck.save_delta(d, 5, t1, t0, 0, threshold=1e-3)
    man = json.load(open(os.path.join(path, "manifest.json")))
    assert [m["changed"] for m in man["leaves"]] == [False, True, False]
    tree, _ = ck.restore_delta(d, _t0())
    # the sub-threshold drift on 'a' is dropped (bounded staleness); 'b'
    # restores to the new value
    assert torch.equal(tree["a"], t0["a"])
    assert torch.equal(tree["b"], t1["b"])


def test_restore_delta_chain_onto_base(tmp_path):
    d = str(tmp_path)
    t0 = _t0()
    t1 = dict(t0, a=t0["a"] + 1.0)
    t2 = dict(t1, b=t1["b"] * 2.0)
    ck.save(d, 0, t0, keep_last=0)
    ck.save_delta(d, 10, t1, t0, 0, touched={0: [1, 2]})
    ck.save_delta(d, 20, t2, t1, 10, touched={1: [7]})
    tree, man = ck.restore_delta(d, _t0())
    _equal_trees(tree, t2)
    assert man["base_full_step"] == 0
    assert [c["step"] for c in man["chain"]] == [10, 20]
    assert man["touched"] == {"0": [1, 2], "1": [7]}      # chain union
    # a pinned intermediate step restores the mid-chain state
    mid, mman = ck.restore_delta(d, _t0(), step=10)
    assert torch.equal(mid["a"], t1["a"])
    assert torch.equal(mid["b"], t0["b"])
    assert mman["touched"] == {"0": [1, 2]}


def test_restore_delta_broken_chain_falls_back(tmp_path):
    d = str(tmp_path)
    t0, t1 = _t0(), dict(_t0(), a=_t0()["a"] + 1)
    t2 = dict(t1, b=t1["b"] * 3)
    ck.save(d, 0, t0, keep_last=0)
    ck.save_delta(d, 10, t1, t0, 0)
    ck.save_delta(d, 20, t2, t1, 10)
    shutil.rmtree(os.path.join(d, f"delta-{10:010d}"))    # break the chain
    tree, man = ck.restore_delta(d, _t0())
    # delta-20 cannot be restored: back to the full base, as restore_latest
    # skips corrupted snapshots
    assert man["step"] == 0
    assert torch.equal(tree["a"], t0["a"])


def test_restore_delta_skips_a_corrupted_delta(tmp_path):
    d = str(tmp_path)
    t0 = _t0()
    t1 = dict(t0, a=t0["a"] + 1.0)
    ck.save(d, 0, t0, keep_last=0)
    path = ck.save_delta(d, 10, t1, t0, 0)
    man = json.load(open(os.path.join(path, "manifest.json")))
    man["leaves"][0]["crc32"] ^= 1
    json.dump(man, open(os.path.join(path, "manifest.json"), "w"))
    tree, rman = ck.restore_delta(d, _t0())
    assert rman["step"] == 0
    _equal_trees(tree, t0)


def test_save_delta_refuses_another_structure(tmp_path):
    t0 = _t0()
    with pytest.raises(ValueError, match="structure"):
        ck.save_delta(str(tmp_path), 1, {"a": t0["a"]}, t0, 0)


def test_gc_deltas_drops_pre_full_chains(tmp_path):
    d = str(tmp_path)
    t0 = _t0()
    ck.save(d, 0, t0, keep_last=0)
    ck.save_delta(d, 10, t0, t0, 0)
    ck.save(d, 20, t0, keep_last=0)
    ck.save_delta(d, 30, t0, t0, 20)
    names = sorted(os.listdir(d))
    assert f"delta-{10:010d}" not in names        # obsolete: pre-newest-full
    assert f"delta-{30:010d}" in names
    assert f"step-{0:010d}" in names and f"step-{20:010d}" in names


def test_deltas_are_invisible_to_restore_latest(tmp_path):
    d = str(tmp_path)
    t0 = _t0()
    ck.save(d, 0, t0, keep_last=0)
    ck.save_delta(d, 10, dict(t0, a=t0["a"] + 1), t0, 0)
    _, man = ck.restore_latest(d, _t0())
    assert man["step"] == 0


def test_restore_latest_pinned_step_missing_returns_none(tmp_path):
    d = str(tmp_path)
    t0 = _t0()
    ck.save(d, 5, t0, keep_last=0)
    assert ck.restore_latest(d, t0, step=999) is None
    got = ck.restore_latest(d, t0, step=5)
    assert got is not None and got[1]["step"] == 5


def test_restore_latest_ignores_partial_tmp_dir(tmp_path):
    """A save killed between the tmp write and the rename leaves ``tmp-*``
    debris; restores skip it and the next save's GC reaps it."""
    d = str(tmp_path)
    t0 = _t0()
    ck.save(d, 5, t0, keep_last=3)
    partial = os.path.join(d, "tmp-7")
    os.makedirs(partial)
    with open(os.path.join(partial, "manifest.json"), "w") as f:
        f.write('{"step": 7')                       # truncated mid-write
    got = ck.restore_latest(d, t0)
    assert got is not None and got[1]["step"] == 5
    assert ck.restore_latest(d, t0, step=7) is None
    ck.save(d, 9, t0, keep_last=3)                  # GC races the debris
    assert not os.path.exists(partial)
    assert ck.restore_latest(d, t0)[1]["step"] == 9


# ---------------------------------------------------------------------------
# tests/test_elastic.py's atomicity and pinned-step cases on the port
# ---------------------------------------------------------------------------

def test_async_checkpoint_atomicity_kill_before_rename(monkeypatch,
                                                        tmp_path):
    """A crash between the tmp write and the rename leaves the previous
    snapshot as the restore target; the half-written tmp dir is never
    picked up and is GC'd by the next successful save."""
    d = str(tmp_path)
    tree = {"a": torch.arange(4.0)}
    ck.save(d, 1, tree)
    real_rename = os.rename

    def killed(src, dst, *a, **kw):
        if os.path.basename(str(src)).startswith("tmp-"):
            raise RuntimeError("killed between write and rename")
        return real_rename(src, dst, *a, **kw)

    monkeypatch.setattr(os, "rename", killed)
    saver = ck.AsyncCheckpointer(d)
    saver.save(2, {"a": tree["a"] * 2})
    with pytest.raises(RuntimeError):
        saver.wait()                     # the async error surfaces
    monkeypatch.undo()
    restored, manifest = ck.restore_latest(d, tree)
    assert manifest["step"] == 1
    assert torch.equal(restored["a"], torch.arange(4.0))
    assert any(x.startswith("tmp-2") for x in os.listdir(d))
    ck.save(d, 3, tree)                  # the next good save GCs the orphan
    assert not any(x.startswith("tmp-") for x in os.listdir(d))


def test_restore_latest_pinned_step(tmp_path):
    d = str(tmp_path)
    tree = {"a": torch.arange(3.0)}
    ck.save(d, 10, tree)
    ck.save(d, 20, {"a": tree["a"] + 1})
    got, manifest = ck.restore_latest(d, tree, step=10)
    assert manifest["step"] == 10 and torch.equal(got["a"], tree["a"])
    assert ck.restore_latest(d, tree, step=15) is None


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _states(kind: str):
    """A dlrm-rm2 smoke adagrad state of each package, the port's carried
    from the JAX package's init, after two JAX steps (accumulators
    nonzero)."""
    jcfg = j_get_arch("dlrm-rm2").make_config("smoke", embedding=kind)
    tcfg = t_get_arch("dlrm-rm2").make_config("smoke", embedding=kind)
    jo = jopt.make_optimizer(jopt.OptimizerConfig(kind="adagrad", lr=0.05))
    to = topt.make_optimizer(topt.OptimizerConfig(kind="adagrad", lr=0.05))
    jstate = jtl.init_state(jrec.init_params(jax.random.PRNGKey(0), jcfg),
                            jo, jtl.TrainConfig())
    jstep = jtl.build_train_step(lambda p, b: jrec.loss_fn(p, jcfg, b), jo,
                                 jtl.TrainConfig(),
                                 project=jrec.make_project_fn(jcfg))
    stream = CtrStream(CtrDataConfig(vocab_sizes=jcfg.vocab_sizes,
                                     n_dense=jcfg.n_dense, batch_size=32))
    for k in range(2):
        jstate, _ = jstep(jstate, {key: jnp.asarray(v) for key, v in
                                   stream.batch_at(k).items()})
    jstate = jax.tree.map(np.asarray, jstate)
    tparams = trec.init_params(tcfg, torch.Generator().manual_seed(1), "cpu")
    tstate = ttl.init_state(tparams, to, ttl.TrainConfig())
    return jstate, tstate


@pytest.mark.parametrize("kind", ("robe", "qrobe", "full"))
def test_jax_checkpoint_restores_into_the_port(kind, tmp_path):
    d = str(tmp_path)
    jstate, tstate = _states(kind)
    jck.save(d, 2, jstate)
    got, man = ck.restore_latest(d, tstate)
    assert man["step"] == 2 and int(got["step"]) == 2
    assert got["step"].dtype == torch.int32 and got["step"].dim() == 0
    if kind == "qrobe":
        assert got["params"]["embedding"]["codes"].dtype == torch.int8
    _equal_trees(got, jstate)


@pytest.mark.parametrize("kind", ("robe", "qrobe", "full"))
def test_port_checkpoint_restores_into_jax(kind, tmp_path):
    d = str(tmp_path)
    jstate, _ = _states(kind)
    tstate = params_from_numpy(jstate, "cpu")
    ck.save(d, 2, tstate)
    template = jax.tree.map(jnp.zeros_like, jstate)
    got, man = jck.restore_latest(d, template)
    assert man["step"] == 2
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(jstate)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_none_leaves_cross_the_packages(tmp_path):
    """``None`` is a leaf of the port's trees and an empty subtree of
    ``jax.tree``'s: the leaf numbering skips it both ways."""
    a = np.arange(5, dtype=np.float32)
    b = np.array([1, -2], np.int8)
    jtree = {"a": a, "n": None, "x": [None, b]}
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jck.save(jdir, 1, jtree)
    ttemplate = {"a": torch.zeros(5), "n": None,
                 "x": [None, torch.zeros(2, dtype=torch.int8)]}
    got, _ = ck.restore_latest(jdir, ttemplate)
    assert got["n"] is None and got["x"][0] is None
    _equal_trees(got, jtree)
    ck.save(tdir, 1, {"a": torch.from_numpy(a), "n": None,
                      "x": [None, torch.from_numpy(b)]})
    back, _ = jck.restore_latest(tdir, jtree)
    assert back["n"] is None and back["x"][0] is None
    np.testing.assert_array_equal(back["a"], a)
    np.testing.assert_array_equal(back["x"][1], b)


def test_jax_bf16_leaf_restores_as_bf16(tmp_path):
    """np.load gives the JAX package's bf16 leaf back as two raw bytes an
    element (``|V2``): the port reads their bits as bf16."""
    d = str(tmp_path)
    w = jnp.asarray(np.linspace(-3, 3, 7, dtype=np.float32)).astype(
        jnp.bfloat16)
    jck.save(d, 1, {"w": w})
    got, man = ck.restore_latest(d, {"w": torch.zeros(7,
                                                      dtype=torch.bfloat16)})
    assert man["leaves"][0]["dtype"] == "bfloat16"
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].float().numpy(),
                                  np.asarray(w, np.float32))
    # the same bytes: the port's own save of that leaf has the same CRC
    ck.save(str(tmp_path / "p"), 1, got)
    pman = json.load(open(os.path.join(str(tmp_path / "p"),
                                       f"step-{1:010d}", "manifest.json")))
    assert pman["leaves"][0]["crc32"] == man["leaves"][0]["crc32"]


@pytest.mark.parametrize("direction", ("jax_to_port", "port_to_jax"))
def test_delta_chain_crosses_the_packages(direction, tmp_path):
    """A full snapshot and two deltas written by one package, restored by
    the other: the chain's leaves bit for bit, and the merged touched
    map."""
    d = str(tmp_path)
    jstate, _ = _states("qrobe")
    rs = np.random.RandomState(0)
    j1 = jax.tree.map(lambda x: x, jstate)
    j1["params"]["embedding"]["delta"] = rs.randn(
        *jstate["params"]["embedding"]["delta"].shape).astype(np.float32)
    j2 = jax.tree.map(lambda x: x, j1)
    j2["params"]["top"][0]["w"] = j1["params"]["top"][0]["w"] + 1.0
    j2["step"] = np.asarray(9, np.int32)
    if direction == "jax_to_port":
        jck.save(d, 2, jstate)
        jck.save_delta(d, 5, j1, jstate, 2, touched={0: [4, 2]})
        jck.save_delta(d, 9, j2, j1, 5, touched={0: [3], 5: [11]})
        got, man = ck.restore_delta(d, params_from_numpy(jstate, "cpu"))
        _equal_trees(got, j2)
        mid, _ = ck.restore_delta(d, params_from_numpy(jstate, "cpu"), step=5)
        _equal_trees(mid, j1)
    else:
        t0, t1, t2 = (params_from_numpy(t, "cpu") for t in (jstate, j1, j2))
        ck.save(d, 2, t0)
        ck.save_delta(d, 5, t1, t0, 2, touched={0: [4, 2]})
        ck.save_delta(d, 9, t2, t1, 5, touched={0: [3], 5: [11]})
        got, man = jck.restore_delta(d, jstate)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(j2)):
            assert np.asarray(g).dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert man["step"] == 9 and man["base_full_step"] == 2
    assert [c["step"] for c in man["chain"]] == [5, 9]
    assert man["touched"] == {"0": [2, 3, 4], "5": [11]}
    # the same changed leaves either way
    changed = [m["changed"] for m in json.load(open(os.path.join(
        d, f"delta-{9:010d}", "manifest.json")))["leaves"]]
    assert sum(changed) == 2


# ---------------------------------------------------------------------------
# the run loop's fault paths (tests/test_elastic.py, tests/test_system.py)
# ---------------------------------------------------------------------------

class _Faults:
    """Injected faults at global steps, for either package's ``run``:
    ``raise_steps`` raise once each in the step (a node failure: the retry
    after the restart succeeds), ``nan_steps`` poison every float leaf of
    the batch to NaN.  ``clock`` advances one unit a step."""

    def __init__(self, nan_steps=(), raise_steps=()):
        self.nan_steps, self.raise_steps = set(nan_steps), set(raise_steps)
        self.raised = set()
        self.t = 0.0

    def clock(self) -> float:
        return self.t

    def step_fn(self, step_fn):
        def wrapped(state, batch):
            step = int(np.asarray(state["step"]))
            if step in self.raise_steps and step not in self.raised:
                self.raised.add(step)
                raise RuntimeError("node died")
            out = step_fn(state, batch)
            self.t += 1.0
            return out
        return wrapped

    def batch_at(self, batch_at):
        def wrapped(step):
            b = batch_at(step)
            if step in self.nan_steps:
                b = {k: np.full_like(v, np.nan)
                     if np.issubdtype(np.asarray(v).dtype, np.floating)
                     else v for k, v in b.items()}
            return b
        return wrapped


VOCABS = (500, 300, 800)


def _toy(jax_side: bool = False):
    """tests/test_elastic.py's toy problem: (cfg, params, stream) of the
    port, and of the JAX package with ``jax_side`` (the port's params
    carried from the same JAX init)."""
    kw = dict(name="d", arch="dlrm", n_dense=4, bot_mlp=(16, 8),
              top_mlp=(16, 1), embed_dim=8, vocab_sizes=VOCABS,
              robe_size=2048, robe_block=8, embedding="robe")
    jcfg = jrec.RecsysConfig(**kw)
    jparams = jrec.init_params(jax.random.PRNGKey(0), jcfg)
    stream = CtrStream(CtrDataConfig(vocab_sizes=VOCABS, n_dense=4,
                                     batch_size=256))
    if jax_side:
        return jcfg, jparams, stream
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return trec.RecsysConfig(**kw), tparams, stream


def _loop(mod, rec, cfg, **kw):
    kw.setdefault("checkpoint_every", 5)
    tc = mod.TrainConfig(**kw)
    opt_mod = jopt if mod is jtl else topt
    opt = opt_mod.make_optimizer(opt_mod.OptimizerConfig(kind="adagrad",
                                                         lr=0.05))
    step_fn = mod.build_train_step(lambda p, b: rec.loss_fn(p, cfg, b), opt,
                                   tc)
    return opt, tc, step_fn


def _port_run(tmp, n_steps, faults, ckpt=True, **kw):
    cfg, params, stream = _toy()
    opt, tc, step_fn = _loop(ttl, trec, cfg, **kw)
    return ttl.run(ttl.init_state(params, opt, tc), faults.step_fn(step_fn),
                   faults.batch_at(stream.batch_at), n_steps, tc,
                   ckpt_dir=tmp if ckpt else None, timer=faults.clock)


def test_nan_batch_restores_and_skips(tmp_path):
    rep = _port_run(str(tmp_path), 20, _Faults(nan_steps={12}))
    assert rep.nan_events == 1
    assert rep.steps_done == 20
    assert len(rep.losses) == 19         # the poisoned step is skipped
    assert np.isfinite(rep.losses).all()
    # the restore rewound: without a checkpoint the loop keeps the
    # step-12 state and the trajectory after the fault differs
    rep2 = _port_run(None, 20, _Faults(nan_steps={12}), ckpt=False)
    assert rep2.nan_events == 1
    assert np.max(np.abs(np.asarray(rep.losses[-7:])
                         - np.asarray(rep2.losses[-7:]))) > 0.0


def test_nan_restore_is_deterministic(tmp_path):
    """Same faults, same stream: the same loss trajectory bit for bit."""
    reps = [_port_run(str(tmp_path / str(i)), 15, _Faults(nan_steps={7}))
            for i in range(2)]
    np.testing.assert_array_equal(np.asarray(reps[0].losses),
                                  np.asarray(reps[1].losses))


def test_bounded_restarts_on_raised_exceptions(tmp_path):
    rep = _port_run(str(tmp_path), 20, _Faults(raise_steps={6, 7, 8}),
                    max_restarts=3)
    assert rep.restarts == 3
    assert rep.steps_done == 20


def test_max_restarts_exceeded_raises(tmp_path):
    with pytest.raises(RuntimeError):
        _port_run(str(tmp_path), 20, _Faults(raise_steps={5, 6, 7, 8}),
                  max_restarts=3)


def test_restart_rewinds_to_the_newest_checkpoint(tmp_path):
    """A raise at step 8 rewinds to the step-5 checkpoint: steps 5..7 run
    twice, and the state restored is that checkpoint's, bit for bit."""
    seen = []

    class Spy(_Faults):
        def step_fn(self, step_fn):
            inner = super().step_fn(step_fn)

            def wrapped(state, batch):
                seen.append((int(state["step"]),
                             state["params"]["embedding"]["memory"].clone()))
                return inner(state, batch)
            return wrapped

    d = str(tmp_path)
    rep = _port_run(d, 10, Spy(raise_steps={8}), keep_last=5)
    assert rep.restarts == 1 and rep.steps_done == 10
    steps = [s for s, _ in seen]
    assert steps == list(range(9)) + list(range(5, 10))
    saved, _ = ck.restore_latest(d, rep.state, step=5)
    # the first step after the restart ran on the step-5 checkpoint
    assert torch.equal(seen[9][1], saved["params"]["embedding"]["memory"])
    # the final save holds the final state
    final, man = ck.restore_latest(d, rep.state)
    assert man["step"] == 10
    _equal_trees(final, rep.state)


def test_run_resumes_from_the_newest_checkpoint(tmp_path):
    d = str(tmp_path)
    first = _port_run(d, 10, _Faults())
    assert first.steps_done == 10
    again = _port_run(d, 15, _Faults())
    assert again.steps_done == 5 and int(again.state["step"]) == 15
    whole = _port_run(str(tmp_path / "whole"), 15, _Faults())
    np.testing.assert_allclose(first.losses + again.losses, whole.losses,
                               rtol=0, atol=0)


def test_fault_tolerant_end_to_end(tmp_path):
    """tests/test_system.py's fault-tolerant run on the port."""
    vocabs = (2000, 1500, 3000, 800)
    cfg = trec.RecsysConfig(
        name="ft", arch="dlrm", n_dense=4, bot_mlp=(8,), top_mlp=(8, 1),
        embed_dim=8, vocab_sizes=vocabs, embedding="robe", robe_size=1024,
        robe_block=8)
    params = trec.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = topt.make_optimizer(topt.OptimizerConfig(kind="adagrad", lr=0.05))
    tc = ttl.TrainConfig(checkpoint_every=10, max_restarts=2)
    step_fn = ttl.build_train_step(lambda p, b: trec.loss_fn(p, cfg, b), opt,
                                   tc)
    stream = CtrStream(CtrDataConfig(vocab_sizes=vocabs, n_dense=4,
                                     batch_size=256))
    rep = ttl.run(ttl.init_state(params, opt, tc), step_fn, stream.batch_at,
                  35, tc, ckpt_dir=str(tmp_path), inject_fault_at=22)
    assert rep.restarts == 1 and rep.steps_done == 35
    assert np.isfinite(rep.final_loss)


# ---------------------------------------------------------------------------
# the port's run against the JAX package's on the same faults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(n=35, every=10, raise_steps={22}, inject=None),
    dict(n=35, every=10, raise_steps=set(), inject=22),
    dict(n=20, every=5, nan_steps={12}),
    dict(n=20, every=5, nan_steps={7}, raise_steps={13}),
], ids=("raise22", "inject22", "nan12", "nan7_raise13"))
def test_run_matches_jax_under_faults(case, tmp_path):
    reps = []
    for side in ("jax", "port"):
        mod, rec = (jtl, jrec) if side == "jax" else (ttl, trec)
        cfg, params, stream = _toy(jax_side=side == "jax")
        if side == "jax":
            params = jax.tree.map(jnp.copy, params)
        opt, tc, step_fn = _loop(mod, rec, cfg,
                                 checkpoint_every=case["every"])
        faults = _Faults(case.get("nan_steps", ()),
                         case.get("raise_steps", ()))
        reps.append(mod.run(mod.init_state(params, opt, tc),
                            faults.step_fn(step_fn),
                            faults.batch_at(stream.batch_at), case["n"], tc,
                            ckpt_dir=str(tmp_path / side),
                            inject_fault_at=case.get("inject"),
                            timer=faults.clock))
    jr, tr = reps
    for field in ("steps_done", "restarts", "nan_events", "straggler_steps"):
        assert getattr(tr, field) == getattr(jr, field), field
    assert tr.steps_done == case["n"]
    assert len(tr.losses) == len(jr.losses)
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=0, atol=1e-5)
    # both wrote the same checkpoints, and the port's final state restores
    # into the JAX package's structure
    assert sorted(os.listdir(tmp_path / "jax")) == \
        sorted(os.listdir(tmp_path / "port"))
    got, man = jck.restore_latest(str(tmp_path / "port"),
                                  jax.tree.map(np.asarray, jr.state))
    assert man["step"] == case["n"]
    for g, w in zip(jax.tree.leaves(got),
                    jax.tree.leaves(tree_to_numpy(tr.state))):
        np.testing.assert_array_equal(g, w)
