"""The port's training slice against the JAX package, on the CPU.

Inputs are made with numpy from a seed; params come from ``repro``'s init
and are carried into the port with ``convert.params_from_numpy``.  On the
CPU the port's backwards run their plain versions (``kernels/ref.py``);
``chip_smoke.py`` holds the Hopper kernels against those on the card.

Tolerances:

* the ROBE scatter-add (the gradient of M): each slot within
  ``1e-5 · A + 1e-7`` in f32 and ``1e-2 · A`` in bf16, where ``A`` is the
  same scatter of ``|g|``.  A slot sums many aliased contributions, and
  the two packages (and, on the card, the atomics) add them in different
  orders, so the bound scales with what the slot received; bf16 adds one
  rounding of the f32 sum, at most 2^-8 of it.  Never bit equality;
* the dot interaction's gradient and every dense gradient: rtol = atol =
  1e-5 in f32 and 1e-2 in bf16;
* ``loss_fn``'s loss: 1e-6; optimizer trees after three updates: 1e-6;
* the quickstart milestone (400 adagrad steps): every port step from the
  JAX run's state before it, its loss within 1e-5 and each param leaf's
  updates within 1e-4 of their norm; the free-running port run's step 0
  within 1e-5 and its held-out AUC within 2e-3 of the JAX run's (its
  later steps may drift: a change of summation order can flip a ReLU);
  the port's forward on the JAX run's final params, AUC within 1e-5.

A CPU call must launch no kernel: every ``launches`` count stays 0.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.core.robe import RobeSpec as JRobeSpec
from repro.data.synthetic_ctr import CtrDataConfig, CtrStream
from repro.kernels import ops as jops
from repro.models import recsys as jrec
from repro.train import metrics as jmetrics
from repro.train import optimizer as jopt
from repro.train import train_loop as jtl
from repro_torch import kernels as tk
from repro_torch import tree as ttree
from repro_torch.configs.registry import get_arch as t_get_arch
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.core.robe import RobeSpec as TRobeSpec
from repro_torch.core.robe import robe_slots as trobe_slots
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import robe_lookup_bwd_ref
from repro_torch.models import recsys as trec
from repro_torch.train import metrics as tmetrics
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as ttl

TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=1e-2, atol=1e-2)}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
#: the ROBE array of the gradient tests: a prime number of slots, small
#: enough that many elements alias each slot
M_SLOTS = 1021


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small tensors: the suite runs
    several test processes on the same cores, and a pool of a thread a
    core in each of them oversubscribes the machine (the quickstart's
    port runs, about 4 s alone here, took minutes beside the others)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_launches():
    """Every test here runs on the CPU: no kernel may be launched."""
    tk.reset_launches()
    yield
    counts = tk.launch_counts()
    assert len(counts) == len(tk.CUDA_KERNELS)
    assert all(n == 0 for n in counts.values()), counts


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.to(torch.float32).numpy() if x.is_floating_point() \
            else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind in "fV" or \
        str(x.dtype) == "bfloat16" else x


def _round(a: np.ndarray, dt: str) -> np.ndarray:
    """``a`` rounded to the working dtype, as f32 numpy."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        TDT[dt]).to(torch.float32).numpy()


def assert_scatter_close(got, want, a, dt: str) -> None:
    """The scatter bound: |got - want| <= 1e-5·A + 1e-7 (f32), 1e-2·A
    (bf16), slot by slot."""
    got, want = _np(got), _np(want)
    a = np.asarray(a, np.float64)
    bound = 1e-5 * a + 1e-7 if dt == "f32" else 1e-2 * a
    err = np.abs(got.astype(np.float64) - want)
    worst = int(np.argmax(err - bound))
    assert (err <= bound).all(), (
        f"slot {worst}: got {got[worst]}, want {want[worst]}, "
        f"A {a[worst]}")


# ---------------------------------------------------------------------------
# the backward of robe_lookup: the sign-corrected scatter-add into M
# ---------------------------------------------------------------------------

def _robe_grads(rows, ct, dim, z, use_sign, dt, use_kernel, size=M_SLOTS,
                seed=3):
    """(port grad, JAX grad, A) of sum(lookup · ct) over M."""
    kw = dict(size=size, block_size=z, seed=7, use_sign=use_sign)
    js, ts = JRobeSpec(**kw), TRobeSpec(**kw)
    mem = np.random.RandomState(seed).randn(size).astype(np.float32)
    tids = tuple(range(rows.shape[1]))
    jct = jnp.asarray(ct)

    def jloss(m):
        out = jops.robe_lookup(m, jnp.asarray(rows), tids, dim, js,
                               use_kernel)
        return (out.astype(jnp.float32) * jct).sum()

    want = jax.grad(jloss)(jnp.asarray(mem, JDT[dt]))
    tmem = torch.from_numpy(mem).to(TDT[dt]).requires_grad_(True)
    out = tops.robe_lookup(tmem, torch.from_numpy(rows), tids, dim, ts)
    (got,) = torch.autograd.grad(
        (out.to(torch.float32) * torch.from_numpy(ct)).sum(), tmem)
    assert got.dtype == TDT[dt] and got.shape == (size,)
    assert want.dtype == JDT[dt]
    # A: the scatter of |g|, g the cotangent the lookup receives (in M's
    # dtype)
    g = torch.from_numpy(np.abs(_round(ct, dt)))
    a = robe_lookup_bwd_ref(g, torch.from_numpy(rows), tids, dim,
                            dataclasses.replace(ts, use_sign=False))
    return got, want, a


@pytest.mark.parametrize("b,f,dim,z", [
    (17, 3, 24, 16),      # Z < d, d not a multiple of Z, prime batch
    (13, 4, 16, 16),      # Z = d
    (7, 2, 8, 32),        # Z > d: rows share blocks
    (11, 3, 40, 1),       # Z = 1: every element hashed alone
    (5, 3, 130, 32),      # d past one 128-element chunk, not a multiple
])
@pytest.mark.parametrize("use_sign", (False, True))
@pytest.mark.parametrize("dt", ("f32", "bf16"))
@pytest.mark.parametrize("use_kernel", (False, True), ids=("jnp", "pallas"))
def test_robe_lookup_grad_matches_jax(b, f, dim, z, use_sign, dt,
                                      use_kernel):
    rs = np.random.RandomState(b * 31 + dim)
    rows = rs.randint(0, 40_000_000, (b, f)).astype(np.int32)
    rows[0, 0] = 2 ** 31 - 1                    # x*d past 2^32
    ct = rs.randn(b, f, dim).astype(np.float32)
    got, want, a = _robe_grads(rows, ct, dim, z, use_sign, dt, use_kernel)
    assert_scatter_close(got, want, a, dt)


def _wrapping_rows(spec: TRobeSpec, f: int, dim: int, n: int) -> np.ndarray:
    """[n, f] rows, each with at least one field whose elements cross the
    end of the circular array (slot |M|-1, then slot 0)."""
    rs = np.random.RandomState(11)
    cand = torch.from_numpy(rs.randint(0, 1_000_000, (4096, f))
                            .astype(np.int32))
    slots = trobe_slots(spec, torch.arange(f)[None, :], cand, dim)
    wraps = ((slots[..., :-1] == spec.size - 1)
             & (slots[..., 1:] == 0)).any(-1).any(-1)
    found = cand[wraps].numpy()
    assert len(found) >= n, "too few rows cross the wrap"
    return found[:n]


@pytest.mark.parametrize("dim,z", [(24, 16), (128, 32)])
@pytest.mark.parametrize("dt", ("f32", "bf16"))
def test_robe_lookup_grad_wraps_at_the_end_of_the_array(dim, z, dt):
    spec = TRobeSpec(size=M_SLOTS, block_size=z, seed=7, use_sign=True)
    rows = _wrapping_rows(spec, 3, dim, 9)
    ct = np.random.RandomState(dim).randn(9, 3, dim).astype(np.float32)
    got, want, a = _robe_grads(rows, ct, dim, z, True, dt, False)
    assert_scatter_close(got, want, a, dt)
    # the two slots either side of the wrap received gradient
    assert float(a[0]) > 0 and float(a[M_SLOTS - 1]) > 0


# ---------------------------------------------------------------------------
# the backward of dot_interaction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,f,d", [(16, 3, 24), (13, 27, 128), (7, 5, 40),
                                   (1, 2, 1), (5, 9, 3), (3, 33, 130)])
@pytest.mark.parametrize("self_interaction", (False, True))
@pytest.mark.parametrize("dt", ("f32", "bf16"))
def test_dot_interaction_grad_matches_jax(b, f, d, self_interaction, dt):
    rs = np.random.RandomState(b + f + d)
    feats = rs.randn(b, f, d).astype(np.float32)
    n = f * (f + 1) // 2 if self_interaction else f * (f - 1) // 2
    ct = rs.randn(b, n).astype(np.float32)

    def jloss(x):
        out = jops.dot_interaction(x, self_interaction, True)
        return (out.astype(jnp.float32) * jnp.asarray(ct)).sum()

    want = jax.grad(jloss)(jnp.asarray(feats, JDT[dt]))
    tf = torch.from_numpy(feats).to(TDT[dt]).requires_grad_(True)
    out = tops.dot_interaction(tf, self_interaction)
    (got,) = torch.autograd.grad(
        (out.to(torch.float32) * torch.from_numpy(ct)).sum(), tf)
    assert got.dtype == TDT[dt] and got.shape == (b, f, d)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dt])


# ---------------------------------------------------------------------------
# loss_fn and its gradient, end to end through the DLRM
# ---------------------------------------------------------------------------

def _configs(arch: str, embedding: str = "robe"):
    return (j_get_arch(arch).make_config("smoke", embedding=embedding),
            t_get_arch(arch).make_config("smoke", embedding=embedding))


def _batch(cfg, b: int, seed: int, step: int = 3) -> dict:
    stream = CtrStream(CtrDataConfig(vocab_sizes=cfg.vocab_sizes,
                                     n_dense=cfg.n_dense, batch_size=b,
                                     seed=seed))
    return stream.batch_at(step)


def _to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ("dlrm-rm2", "dlrm-criteo-tb"))
def test_loss_fn_and_grads_match_jax(arch):
    jcfg, tcfg = _configs(arch)
    jparams = jrec.init_params(jax.random.PRNGKey(1), jcfg)
    batch = _batch(jcfg, 64, seed=8)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jrec.loss_fn(p, jcfg, jb), has_aux=True)(jparams)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tb = _to_torch(batch)
    live = ttree.tree_map(lambda p: p.requires_grad_(True), tparams)
    tl, tm = trec.loss_fn(live, tcfg, tb)
    tg = torch.autograd.grad(tl, ttree.leaves(live))
    assert abs(float(tl.detach()) - float(jl)) <= 1e-6
    assert abs(float(tm["logloss"].detach()) - float(jm["logloss"])) <= 1e-6

    # A of the memory's scatter: |g| of the embeddings, taken through the
    # batch's "emb" bypass of the lookup
    spec = tcfg.embedding_spec()
    emb = trec._embed(tparams, tcfg, tb["sparse"]).detach()
    emb.requires_grad_(True)
    (g_emb,) = torch.autograd.grad(
        trec.loss_fn(tparams, tcfg, dict(tb, emb=emb))[0], emb)
    a = robe_lookup_bwd_ref(g_emb.abs(), tb["sparse"],
                            tuple(range(spec.n_fields)), spec.dim,
                            dataclasses.replace(spec.robe, use_sign=False))
    jflat = ttree.leaves(jax.tree.map(np.asarray, jg))
    names = [k for k, _ in jax.tree_util.tree_leaves_with_path(jg)]
    assert len(jflat) == len(tg) == len(names)
    for name, got, want in zip(names, tg, jflat):
        if "memory" in jax.tree_util.keystr(name):
            assert_scatter_close(got, want, a, "f32")
        else:
            np.testing.assert_allclose(_np(got), want, **TOL["f32"],
                                       err_msg=jax.tree_util.keystr(name))


def test_make_project_fn():
    for arch in ("dlrm-rm2", "dlrm-criteo-tb"):
        for emb in ("robe", "hashed", "tt"):
            assert trec.make_project_fn(_configs(arch, emb)[1]) is None
    # qrobe's fold: the hook runs on the whole param dict, requantizes the
    # embedding subtree, re-zeroes delta and leaves the rest as it was
    qcfg = _configs("dlrm-rm2", "qrobe")[1]
    project = trec.make_project_fn(qcfg)
    size = qcfg.embedding_spec().robe.size
    codes = torch.zeros(size, dtype=torch.int8)
    codes[:2] = torch.tensor([3, -2], dtype=torch.int8)
    delta = torch.zeros(size)
    delta[:2] = torch.tensor([0.26, -0.74])
    emb = {"codes": codes, "scale": torch.full((-(-size // 256),), 0.5),
           "delta": delta}
    top = [torch.ones(2)]
    out = project({"embedding": emb, "top": top})
    assert out["top"] is top
    assert out["embedding"]["codes"][:3].tolist() == [4, -3, 0]
    assert not bool(out["embedding"]["delta"].any())
    # the hook depends on the substrate alone: a dcn model gets none on
    # robe and qrobe's projection on qrobe, as a dlrm model does
    dcn = dict(arch="dcn", cross_layers=2, dnn=(16,))
    assert trec.make_project_fn(dataclasses.replace(
        _configs("dlrm-rm2")[1], **dcn)) is None
    qdcn = trec.make_project_fn(dataclasses.replace(qcfg, **dcn))
    qout = qdcn({"embedding": emb, "top": top})
    assert qout["top"] is top
    for k in ("codes", "scale", "delta"):
        assert torch.equal(qout["embedding"][k], out["embedding"][k])
    # an unknown arch raises in its forward, as the JAX package's does
    jcfg, tcfg = _configs("dlrm-rm2")
    jparams = jrec.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rs = np.random.RandomState(0)
    batch = {"dense": rs.randn(4, 13).astype(np.float32),
             "sparse": rs.randint(0, 40, (4, 6)).astype(np.int32),
             "label": rs.randint(0, 2, 4).astype(np.int32)}
    with pytest.raises(ValueError, match="forward undefined for bogus"):
        jrec.loss_fn(jparams, dataclasses.replace(jcfg, arch="bogus"), batch)
    with pytest.raises(ValueError, match="forward undefined for bogus"):
        trec.loss_fn(tparams, dataclasses.replace(tcfg, arch="bogus"),
                     {k: torch.from_numpy(v) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _opt_params(rs) -> dict:
    f = lambda *s: rs.randn(*s).astype(np.float32)
    return {"embedding": {"memory": f(257),
                          "codes": rs.randint(-127, 128, 16).astype(np.int8)},
            "bot": [{"w": f(6, 5), "b": f(5)}, {"w": f(5, 1)}],
            "stack": f(4, 3, 2)}


def _opt_grads(rs, params, frozen) -> dict:
    """Grads well away from 0 (an adaptive step g/(|g|+eps) would turn
    tiny sum-order noise into ±lr)."""
    def one(p):
        if p.dtype == np.int8:
            return frozen(p)
        g = rs.randn(*p.shape).astype(np.float32)
        return np.sign(g) * (0.5 + np.abs(g))
    return jax.tree.map(one, params)


OPTIMIZERS = {
    "sgd": dict(kind="sgd", lr=0.1),
    "sgd-momentum-clip-warmup": dict(kind="sgd", lr=0.1, momentum=0.9,
                                     grad_clip=1.0, warmup_steps=2),
    "adagrad": dict(kind="adagrad", lr=0.08),
    "adagrad-cosine": dict(kind="adagrad", lr=0.08, warmup_steps=1,
                           decay_steps=5),
    "adam": dict(kind="adam", lr=1e-2),
    "adam-bf16-moments-sliced": dict(kind="adam", lr=1e-2,
                                     moment_dtype="bf16",
                                     update_scan_dim0=3),
    "adamw-master": dict(kind="adamw", lr=1e-2, weight_decay=0.05,
                         master_weights=True, grad_clip=2.0),
    "adafactor": dict(kind="adafactor", lr=1e-2),
}


def _tree_close(got, want, tol: float) -> None:
    gl, wl = ttree.leaves(got), ttree.leaves(jax.tree.map(np.asarray, want))
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), _np(w), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_jax(name):
    kw = dict(OPTIMIZERS[name])
    mdt = kw.pop("moment_dtype", "f32")
    jo = jopt.make_optimizer(jopt.OptimizerConfig(moment_dtype=JDT[mdt], **kw))
    to = topt.make_optimizer(topt.OptimizerConfig(moment_dtype=TDT[mdt], **kw))
    rs = np.random.RandomState(sorted(OPTIMIZERS).index(name))
    params = _opt_params(rs)
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_numpy(params, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    _tree_close(tree_to_numpy(ts), js, 0.0)
    for step in range(3):
        grads = _opt_grads(rs, params,
                           lambda p: np.zeros(p.shape, jax.dtypes.float0))
        jg = jax.tree.map(lambda g: g if g.dtype == jax.dtypes.float0
                          else jnp.asarray(g), grads)
        tg = params_from_numpy(jax.tree.map(
            lambda g: np.zeros(0) if g.dtype == jax.dtypes.float0 else g,
            grads), "cpu")
        tg["embedding"]["codes"] = None                 # no gradient
        jp, js = jo.update(jp, jg, js, jnp.asarray(step, jnp.int32))
        tp, ts = to.update(tp, tg, ts,
                           torch.tensor(step, dtype=torch.int32))
        _tree_close(tree_to_numpy(tp), jp, 1e-6)
        _tree_close(tree_to_numpy(ts), js, 1e-6)
    # the integer leaf is frozen
    np.testing.assert_array_equal(tp["embedding"]["codes"].numpy(),
                                  params["embedding"]["codes"])


def test_optimizer_state_loads_from_jax_leaf_by_leaf():
    """A JAX adam state (with master weights) carried across by
    ``params_from_numpy`` continues in the port as in the JAX package."""
    cfg = dict(kind="adamw", lr=1e-2, weight_decay=0.05, master_weights=True)
    jo = jopt.make_optimizer(jopt.OptimizerConfig(**cfg))
    to = topt.make_optimizer(topt.OptimizerConfig(**cfg))
    rs = np.random.RandomState(5)
    params = _opt_params(rs)
    del params["embedding"]["codes"]
    jp = jax.tree.map(jnp.asarray, params)
    js = jo.init(jp)
    grads = [_opt_grads(rs, params, None) for _ in range(2)]
    jp, js = jo.update(jp, jax.tree.map(jnp.asarray, grads[0]), js, 0)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ts = params_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    jp, js = jo.update(jp, jax.tree.map(jnp.asarray, grads[1]), js, 1)
    tp, ts = to.update(tp, params_from_numpy(grads[1], "cpu"), ts,
                       torch.tensor(1, dtype=torch.int32))
    _tree_close(tree_to_numpy(tp), jp, 1e-6)
    _tree_close(tree_to_numpy(ts), js, 1e-6)


def test_schedule_matches_jax():
    for kw in (dict(lr=0.3), dict(lr=0.3, warmup_steps=4),
               dict(lr=0.3, warmup_steps=2, decay_steps=9)):
        for step in range(12):
            want = float(jopt.schedule(jopt.OptimizerConfig(**kw), step))
            got = topt.schedule(topt.OptimizerConfig(**kw),
                                torch.tensor(step))
            assert got.dtype == torch.float32
            assert abs(float(got) - want) <= 1e-7


# ---------------------------------------------------------------------------
# the train step and the run loop
# ---------------------------------------------------------------------------

def _train_pair(arch: str, opt: dict, cfg_kw: dict, seed: int = 0):
    jcfg, tcfg = _configs(arch)
    jparams = jrec.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jo = jopt.make_optimizer(jopt.OptimizerConfig(**opt))
    to = topt.make_optimizer(topt.OptimizerConfig(**opt))
    jc, tc = jtl.TrainConfig(**cfg_kw), ttl.TrainConfig(**cfg_kw)
    jstep = jtl.build_train_step(lambda p, b: jrec.loss_fn(p, jcfg, b), jo,
                                 jc)
    tstep = ttl.build_train_step(lambda p, b: trec.loss_fn(p, tcfg, b), to,
                                 tc)
    return ((jtl.init_state(jparams, jo, jc), jstep),
            (ttl.init_state(tparams, to, tc), tstep), jcfg)


@pytest.mark.parametrize("grad_accum", (1, 2))
def test_train_step_matches_jax(grad_accum):
    # SGD with momentum: linear in the grads, so the memory's sum-order
    # differences stay at the scatter's scale (an adaptive step would turn
    # a slot's tiny grad into ±lr)
    (js, jstep), (ts, tstep), cfg = _train_pair(
        "dlrm-rm2", dict(kind="sgd", lr=0.05, momentum=0.9),
        dict(grad_accum=grad_accum))
    assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
    for k in range(3):
        batch = _batch(cfg, 64, seed=4, step=k)
        js, jm = jstep(js, {key: jnp.asarray(v) for key, v in batch.items()})
        ts, tm = tstep(ts, _to_torch(batch))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-6
        assert float(tm["finite"]) == 1.0
        want = jax.tree.map(np.asarray, js)
        got = tree_to_numpy(ts)
        assert int(got["step"]) == int(want["step"]) == k + 1
        # params and momentum
        for g, w in zip(ttree.leaves(got["params"]),
                        ttree.leaves(want["params"])):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
        for g, w in zip(ttree.leaves(got["opt"]), ttree.leaves(want["opt"])):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_nan_guard_keeps_state():
    _, (ts, tstep), cfg = _train_pair("dlrm-criteo-tb",
                                      dict(kind="adam", lr=1e-2), {})
    batch = _to_torch(_batch(cfg, 32, seed=6))
    ts, _ = tstep(ts, batch)
    before = tree_to_numpy(ts)
    poisoned = dict(batch, dense=batch["dense"].clone())
    poisoned["dense"][3, 0] = float("nan")
    ts2, m = tstep(ts, poisoned)
    assert float(m["finite"]) == 0.0 and not np.isfinite(float(m["loss"]))
    after = tree_to_numpy(ts2)
    assert int(after["step"]) == int(before["step"]) + 1
    for key in ("params", "opt"):
        for a, b in zip(ttree.leaves(after[key]), ttree.leaves(before[key])):
            np.testing.assert_array_equal(a, b)


def test_run_loop_matches_jax_bookkeeping():
    """Restarts, NaN batches, stragglers and a re-slice, on a scripted
    clock: the port's ``run`` reports what the JAX package's does."""
    (js, jstep), (ts, tstep), cfg = _train_pair(
        "dlrm-rm2", dict(kind="sgd", lr=0.05),
        dict(straggler_patience=2, max_restarts=2))
    stream = CtrStream(CtrDataConfig(vocab_sizes=cfg.vocab_sizes,
                                     n_dense=cfg.n_dense, batch_size=32))
    durations = {5: 40.0, 6: 45.0}          # slow steps: flags, re-slice

    def scripted():
        clock = {"t": 0.0}

        def batch_at(step):
            clock["t"] += durations.get(step, 1.0)
            b = stream.batch_at(step)
            if step == 8:
                b = dict(b, dense=np.full_like(b["dense"], np.nan))
            return b
        calls = []

        def reslice(state, step):
            calls.append(step)
            return state, reslice.step_fn
        return batch_at, (lambda: clock["t"]), reslice, calls

    reports = []
    for state, step_fn, mod in ((js, jstep, jtl), (ts, tstep, ttl)):
        batch_at, timer, reslice, calls = scripted()
        reslice.step_fn = step_fn
        rep = mod.run(state, step_fn, batch_at, 12, mod.TrainConfig(
            straggler_patience=2, max_restarts=2), inject_fault_at=3,
            reslice_fn=reslice, timer=timer)
        reports.append((rep, calls))
    (jr, jcalls), (tr, tcalls) = reports
    for field in ("steps_done", "restarts", "nan_events", "straggler_steps",
                  "reslices"):
        assert getattr(tr, field) == getattr(jr, field), field
    assert tcalls == jcalls and tr.reslices == 1 and tr.nan_events == 1
    assert tr.restarts == 1 and tr.steps_done == 12
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=1e-5, atol=1e-6)
    assert int(tr.state["step"]) == 12


def test_what_is_not_ported_raises(tmp_path):
    (_, _), (ts, tstep), cfg = _train_pair("dlrm-rm2", dict(kind="sgd"), {})
    # checkpoints are ported: run with ckpt_dir saves at the end, and a
    # shardings tree that is not the state's raises
    rep = ttl.run(ts, tstep, lambda s: _batch(cfg, 8, seed=1, step=s), 2,
                  ttl.TrainConfig(), ckpt_dir=str(tmp_path))
    assert rep.steps_done == 2 and rep.restarts == 0
    from repro_torch.train import checkpoint as tck
    got, man = tck.restore_latest(str(tmp_path), rep.state)
    assert man["step"] == 2 and int(got["step"]) == 2
    with pytest.raises(ValueError, match="congruent"):
        tck.restore_latest(str(tmp_path), rep.state, shardings={})
    # grad compression is ported: the state carries the error feedback
    # ([1, ...] f32 zeros a leaf, as the JAX package's [n_dp, ...] on one
    # device), and the step needs a mesh, as the JAX package's asserts
    opt = topt.make_optimizer(topt.OptimizerConfig(kind="sgd"))
    c8 = ttl.TrainConfig(grad_compression="int8")
    st = ttl.init_state(ts["params"], opt, c8)
    jst = jtl.init_state(jax.tree.map(jnp.asarray, tree_to_numpy(
        ts["params"])), jopt.make_optimizer(jopt.OptimizerConfig(
            kind="sgd")), jtl.TrainConfig(grad_compression="int8"))
    for a, b in zip(ttree.leaves(st["ef"]), jax.tree.leaves(jst["ef"])):
        assert tuple(a.shape) == b.shape and not a.any()
    with pytest.raises(ValueError, match="needs a mesh"):
        ttl.build_train_step(lambda p, b: trec.loss_fn(p, cfg, b), opt,
                             c8)(st, _batch(cfg, 8, seed=1, step=0))
    with pytest.raises(ValueError, match="unknown compression"):
        ttl.build_train_step(None, opt, ttl.TrainConfig(
            grad_compression="fp8"))
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.make_optimizer(topt.OptimizerConfig(kind="lion"))


# ---------------------------------------------------------------------------
# the quickstart milestone: examples/quickstart.py in both packages
# ---------------------------------------------------------------------------

QUICKSTART_VOCABS = (40_000, 10_000, 60_000, 5_000)


def _quickstart_config(mod):
    return mod.RecsysConfig(
        name="quickstart", arch="dlrm", n_dense=4, bot_mlp=(32, 16),
        top_mlp=(32, 1), embed_dim=16, vocab_sizes=QUICKSTART_VOCABS,
        embedding="robe", robe_size=sum(QUICKSTART_VOCABS) * 16 // 100,
        robe_block=32)


def _add_update_err(acc: dict, old, new_port, new_jax) -> None:
    """Per param leaf, add |Δport - Δjax|² and |Δjax|² (f64) to ``acc``,
    each Δ the step's change of the leaf from the same ``old`` params."""
    names = jax.tree.leaves(jax.tree_util.tree_map_with_path(
        lambda path, _: jax.tree_util.keystr(path), old))
    for name, o, t, j in zip(names, jax.tree.leaves(old),
                             jax.tree.leaves(new_port),
                             jax.tree.leaves(new_jax)):
        o = np.asarray(o, np.float64)
        want = np.asarray(j, np.float64) - o
        diff = np.asarray(t, np.float64) - o - want
        d, w = acc.get(name, (0.0, 0.0))
        acc[name] = (d + float(np.sum(diff * diff)),
                     w + float(np.sum(want * want)))


def test_quickstart_milestone():
    """400 adagrad steps (lr 0.08, batch 1024) of the quickstart config
    from the same params on the same batches.

    Every port step is held to the JAX step from the same state (the JAX
    run's state before that step, loaded into the port): its loss within
    1e-5, and each param leaf's updates within 1e-4 of their norm over
    the 400 steps (sqrt(Σ|Δport - Δjax|² / Σ|Δjax|²); a backward that
    left a leaf's gradient zero reads 1).  The two free-running
    trajectories are not held to each other step by step: a change of
    summation order alone can flip a ReLU whose input is within rounding
    of 0 and carry them apart by more than 2e-3 (``tools/order_noise.py``),
    so their largest loss difference is printed, not gated.  Of the free
    runs, step 0's loss is held within 1e-5 and the held-out AUC (steps
    5000-5007) within 2e-3; the port's forward on the JAX run's final
    params gives the JAX AUC within 1e-5."""
    jcfg, tcfg = _quickstart_config(jrec), _quickstart_config(trec)
    stream = CtrStream(CtrDataConfig(vocab_sizes=QUICKSTART_VOCABS,
                                     n_dense=4, batch_size=1024))
    jparams = jrec.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    opt = dict(kind="adagrad", lr=0.08)
    jo = jopt.make_optimizer(jopt.OptimizerConfig(**opt))
    to = topt.make_optimizer(topt.OptimizerConfig(**opt))
    jc = jtl.TrainConfig(checkpoint_every=10 ** 9, log_every=20)
    tc = ttl.TrainConfig()
    jstep = jtl.build_train_step(lambda p, b: jrec.loss_fn(p, jcfg, b), jo,
                                 jc)
    tstep = ttl.build_train_step(lambda p, b: trec.loss_fn(p, tcfg, b), to,
                                 tc)
    before = []                 # the JAX run's state before each step

    def recorded(state, batch):
        before.append(jax.tree.map(np.asarray, state))
        return jstep(state, batch)
    jrep = jtl.run(jtl.init_state(jparams, jo, jc), recorded,
                   stream.batch_at, 400, jc)
    trep = ttl.run(ttl.init_state(tparams, to, tc), tstep, stream.batch_at,
                   400, tc)
    assert trep.steps_done == jrep.steps_done == len(before) == 400
    after = before[1:] + [jax.tree.map(np.asarray, jrep.state)]

    step_diff, acc = [], {}
    for k, (old, new) in enumerate(zip(before, after)):
        got, m = tstep(params_from_numpy(old, "cpu"),
                       _to_torch(stream.batch_at(k)))
        step_diff.append(abs(float(m["loss"]) - jrep.losses[k]))
        _add_update_err(acc, old["params"], tree_to_numpy(got["params"]),
                        new["params"])
    rel = {name: (d / w) ** 0.5 for name, (d, w) in acc.items()}
    free = np.abs(np.asarray(trep.losses) - np.asarray(jrep.losses))

    jfwd = jax.jit(lambda p, b: jrec.forward(p, jcfg, b))
    jfinal = params_from_numpy(after[-1]["params"], "cpu")
    js, ts, tj, labels = [], [], [], []
    for s in range(5000, 5008):
        b = stream.batch_at(s)
        js.append(np.asarray(jfwd(jrep.state["params"],
                                  {k: jnp.asarray(v) for k, v in b.items()})))
        with torch.no_grad():
            ts.append(trec.forward(trep.state["params"], tcfg,
                                   _to_torch(b)).numpy())
            tj.append(trec.forward(jfinal, tcfg, _to_torch(b)).numpy())
        labels.append(b["label"])
    labels = np.concatenate(labels)
    jauc = jmetrics.auc(labels, np.concatenate(js))
    tauc = tmetrics.auc(labels, np.concatenate(ts))
    same_auc = tmetrics.auc(labels, np.concatenate(tj))
    # the largest differences seen, for the record (pytest -s shows them)
    print(f"quickstart: loss {trep.losses[0]:.6f} -> {trep.losses[-1]:.6f} "
          f"(JAX {jrep.losses[0]:.6f} -> {jrep.losses[-1]:.6f}); steps "
          f"from the same state: max |loss diff| {max(step_diff):.3e}, "
          f"update error {max(rel.values()):.3e} "
          f"({max(rel, key=rel.get)}); free runs: max |loss diff| "
          f"{free.max():.3e} at step {int(free.argmax())}, step 0 "
          f"{free[0]:.3e}; held-out AUC {tauc:.6f} vs {jauc:.6f} (diff "
          f"{abs(tauc - jauc):.3e}; from the same params "
          f"{abs(same_auc - jauc):.3e})")
    assert max(step_diff) <= 1e-5, (max(step_diff), int(np.argmax(step_diff)))
    assert max(rel.values()) <= 1e-4, rel
    assert free[0] <= 1e-5, free[0]
    assert abs(tauc - jauc) <= 2e-3, (tauc, jauc)
    assert abs(same_auc - jauc) <= 1e-5, (same_auc, jauc)
    assert trep.losses[-1] < trep.losses[0] and tauc > 0.55


# ---------------------------------------------------------------------------
# metrics and trees
# ---------------------------------------------------------------------------

def test_metrics_match_jax():
    rs = np.random.RandomState(0)
    labels = rs.randint(0, 2, 3000)
    logits = np.round(rs.randn(3000), 2)             # ties included
    assert tmetrics.auc(labels, logits) == jmetrics.auc(labels, logits)
    assert tmetrics.logloss(labels, logits) == jmetrics.logloss(labels,
                                                                logits)
    ja, ta = jmetrics.StreamingAuc(1024), tmetrics.StreamingAuc(1024)
    for k in range(3):
        ja.update(labels[k::3], logits[k::3])
        ta.update(labels[k::3], logits[k::3])
    assert ta.value() == ja.value()
    assert tmetrics.auc(np.ones(4), logits[:4]) == 0.5


def test_tree_helpers_follow_jax_tree():
    tree = {"b": [1, (2, 3)], "a": {"z": 4, "y": [5]}, "c": 6}
    assert ttree.leaves(tree) == jax.tree.leaves(tree)
    doubled = ttree.tree_map(lambda x, y: x + y, tree, tree)
    assert doubled == jax.tree.map(lambda x, y: x + y, tree, tree)
    assert list(doubled) == list(tree)               # key order kept
    assert ttree.unflatten(tree, ttree.leaves(tree)) == tree
    assert ttree.leaves_up_to({"a": 1, "b": 2},
                              {"a": {"x": 1}, "b": None}) == [{"x": 1}, None]
    with pytest.raises(ValueError, match="structure"):
        ttree.tree_map(lambda x, y: x, {"a": 1}, {"b": 1})
    with pytest.raises(ValueError, match="more values"):
        ttree.unflatten([1], [1, 2])


def test_tree_to_numpy_inverts_params_from_numpy():
    tree = {"m": np.arange(5, dtype=np.float32),
            "l": [np.ones((2, 3), np.float32), np.int8([1, -2])],
            "s": np.int32(7)}
    back = tree_to_numpy(params_from_numpy(tree, "cpu"))
    for got, want in zip(ttree.leaves(back), ttree.leaves(tree)):
        assert got.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, want)
    bf = tree_to_numpy({"x": torch.ones(3, dtype=torch.bfloat16)})["x"]
    assert bf.dtype == np.float32
