"""The port's spec functions and gradient compression against the JAX
package's, in this process (no spawned ranks).

The JAX spec functions read only ``mesh.axis_names`` and ``mesh.shape``,
so both packages' functions run on the same stand-in meshes -- (2, 4),
(2, 2), (8,), a pod mesh and the degraded (2, 4) -> (2, 2) -- and must
return the same entries: ``axes_*``, ``default_rules``, ``resolve_spec``
(with and without ``shape``), ``prune_specs``, ``recsys_specs``,
``state_specs``, ``train_state_specs`` and every backend's
``param_specs``.  ``compressed_psum`` is held to a numpy transcription of
``repro.train.compression``'s formulas on four ranks' gradients, and to
JAX's own in a one-device ``shard_map`` (the port's on a one-rank gloo
world).
"""

import dataclasses
import types
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as tdist
from jax.sharding import PartitionSpec as JP

from repro.core.robe import RobeSpec as JRobeSpec
from repro.dist import api as jdist
from repro.dist import param_specs as jps
from repro.launch.mesh import degrade_mesh as j_degrade_mesh
from repro.models import recsys as jrec
from repro.nn.embedding_backends import get_backend as j_get_backend
from repro.nn.embeddings import EmbeddingSpec as JSpec
from repro.train import elastic as jel
from repro.train import optimizer as jopt
from repro.train.compression import compressed_psum as j_compressed_psum
from repro_torch.convert import params_from_numpy
from repro_torch.core.robe import RobeSpec
from repro_torch.dist import api as tdist_api
from repro_torch.dist import param_specs as tps
from repro_torch.dist.api import P
from repro_torch.launch import mesh as tmesh
from repro_torch.models import recsys as trec
from repro_torch.nn.embeddings import EmbeddingSpec, get_backend
from repro_torch.train import compression as tcomp
from repro_torch.train import elastic as tel
from repro_torch.train import optimizer as topt

BACKENDS = ("full", "robe", "qrobe", "hashed", "tt")


def _mesh(shape, names):
    return types.SimpleNamespace(axis_names=tuple(names),
                                 shape=dict(zip(names, shape)))


MESHES = {
    "2x4": _mesh((2, 4), ("data", "model")),
    "2x2": _mesh((2, 2), ("data", "model")),
    "8": _mesh((8,), ("data",)),
    "pod": _mesh((2, 2, 4), ("pod", "data", "model")),
    "2x4_degraded": _mesh((2, 2), ("data", "model")),
}


def _same(j, t, where="") -> None:
    """Two spec trees entry by entry: jax PartitionSpecs against the
    port's P, dicts, lists and None."""
    if isinstance(j, JP):
        assert isinstance(t, P), (where, j, t)
        assert tuple(j) == tuple(t), (where, j, t)
    elif isinstance(j, dict):
        assert isinstance(t, dict) and set(j) == set(t), (where, j, t)
        for k in j:
            _same(j[k], t[k], f"{where}/{k}")
    elif isinstance(j, (list, tuple)):
        assert len(j) == len(t), (where, j, t)
        for i, (a, b) in enumerate(zip(j, t)):
            _same(a, b, f"{where}/{i}")
    else:
        assert j is None and t is None, (where, j, t)


def _ctxs(name):
    m = MESHES[name]
    pod = "pod" in m.axis_names
    return (jdist.DistContext(mesh=m, rules=jdist.default_rules(pod)),
            tdist_api.DistContext(mesh=m, rules=tdist_api.default_rules(pod)))


def test_axes_helpers_and_default_rules():
    for rule in (None, "data", ("data",), ("pod", "data"),
                 ("data", "model")):
        assert jdist.axes_tuple(rule) == tdist_api.axes_tuple(rule)
        axes = jdist.axes_tuple(rule)
        if axes:
            assert jdist.axes_entry(axes) == tdist_api.axes_entry(axes)
        for m in list(MESHES.values()) + [None]:
            assert jdist.axes_on_mesh(axes, m) == \
                tdist_api.axes_on_mesh(axes, m)
    for pod in (False, True):
        assert jdist.default_rules(pod) == tdist_api.default_rules(pod)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_context_sizes(mesh):
    jc, tc = _ctxs(mesh)
    assert jc.dp_axes == tc.dp_axes
    assert jc.dp_size == tc.dp_size
    assert jc.n_devices == tc.n_devices


LOGICAL = [("batch", None), ("flat_batch", None, None), ("seq", "embed"),
           ("batch", "seq", "mlp"), ("candidates", None),
           ("table_rows", None), ("vocab", "mlp"), ("flat_batch", "model"),
           (None, "heads"), ("expert", "batch", "mlp"), ("nope", None)]
SHAPES = [(16, 8, 8), (6, 8, 8), (12, 3, 4), (8, 12, 16), (1, 1, 1)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_resolve_spec_matches_jax(mesh):
    jc, tc = _ctxs(mesh)
    for axes in LOGICAL:
        for shape in [None] + SHAPES:
            sh = None if shape is None else shape[:len(axes)]
            if sh is not None and len(sh) < len(axes):
                continue
            j = jdist.resolve_spec(jc, axes, sh)
            t = tdist_api.resolve_spec(tc, axes, sh)
            if j is None:
                assert t is None, (axes, sh, t)
            else:
                _same(j, t, f"{axes} {sh}")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_prune_specs_matches_jax(mesh):
    m = MESHES[mesh]
    specs = [(("data", "model"), None), ("model",), ("data",),
             (("pod", "data"), None), (None, "model"), (),
             ("model", "data"), ((("data", "model"),))]
    shapes = [(12, 8), (6, 8), (8, 8), (512, 8), (16,), (3, 5), (24, 24)]
    for s in specs:
        for shape in shapes:
            if len(s) > len(shape):
                continue
            j = jdist.prune_specs({"x": JP(*s)}, {
                "x": jax.ShapeDtypeStruct(shape, jnp.float32)}, m)
            t = tdist_api.prune_specs({"x": P(*s)},
                                      {"x": np.zeros(shape, np.float32)}, m)
            _same(j, t, f"{s} {shape}")


def test_prune_specs_the_jax_package_cases():
    """tests/test_elastic.py::test_degrade_mesh_and_prune_specs's cases."""
    half = MESHES["2x4_degraded"]
    shapes = {"table": np.zeros((12, 8)), "odd": np.zeros((6, 8)),
              "pod_sharded": np.zeros((8, 8))}
    specs = {"table": P(("data", "model"), None),
             "odd": P(("data", "model"), None),
             "pod_sharded": P(("pod", "data"), None)}
    out = tdist_api.prune_specs(specs, shapes, half)
    assert out["table"] == P(("data", "model"), None)
    assert out["odd"] == P(None, None)
    assert out["pod_sharded"] == P("data", None)


def test_degraded_devices_match_jax():
    """``launch.mesh.degrade_mesh``'s survivors (its pure half) against
    ``repro.launch.mesh.degrade_mesh`` on this process's 8 host devices."""
    jm = jax.make_mesh((2, 4), ("data", "model"))
    ids = np.vectorize(lambda d: d.id)(np.asarray(jm.devices))
    for axis, keep in (("model", None), ("model", 1), ("model", 3),
                       ("data", None)):
        want = np.vectorize(lambda d: d.id)(np.asarray(
            j_degrade_mesh(jm, axis, keep).devices))
        got = ids.reshape(-1)[tmesh.degraded_devices(
            np.arange(8).reshape(2, 4), ("data", "model"), axis, keep)]
        assert np.array_equal(want, got), (axis, keep)
    for axis, keep in (("pod", None), ("model", 4), ("model", 0)):
        with pytest.raises(ValueError):
            j_degrade_mesh(jm, axis, keep)
        with pytest.raises(ValueError):
            tmesh.degraded_devices(np.arange(8).reshape(2, 4),
                                   ("data", "model"), axis, keep)


def _specs(kind, placement="default"):
    robe = RobeSpec(size=512, block_size=8, seed=11)
    jrobe = JRobeSpec(size=512, block_size=8, seed=11)
    kw = dict(vocab_sizes=(64, 96, 32), dim=8, kind=kind,
              placement=placement)
    return JSpec(robe=jrobe, **kw), EmbeddingSpec(robe=robe, **kw)


PLACEMENTS = [(k, "default") for k in BACKENDS] + [("full", "2d"),
                                                   ("full", "model"),
                                                   ("robe", "model")]


@pytest.mark.parametrize("kind,placement", PLACEMENTS)
def test_backend_param_specs_match_jax(kind, placement):
    js, ts = _specs(kind, placement)
    for pod in (False, True):
        for m in [None] + list(MESHES.values()):
            _same(j_get_backend(kind).param_specs(
                      js, jdist.default_rules(pod), mesh=m),
                  get_backend(kind).param_specs(
                      ts, tdist_api.default_rules(pod), mesh=m),
                  f"{kind}/{placement}/{pod}/{m}")


def test_backend_param_specs_re_resolve_on_degraded_mesh():
    """tests/test_elastic.py's case on the port: every backend's layout
    stays legal when an axis disappears."""
    rules = tdist_api.default_rules()
    mesh = MESHES["2x4"]
    for kind in BACKENDS:
        _, spec = _specs(kind)
        assert get_backend(kind).param_specs(spec, rules, mesh=mesh) == \
            get_backend(kind).param_specs(spec, rules)
    _, spec2d = _specs("full", "2d")
    assert get_backend("full").param_specs(spec2d, rules, mesh=mesh) == \
        {"table": P(("data", "model"), None)}
    _, z3 = _specs("robe", "model")
    assert get_backend("robe").param_specs(z3, rules, mesh=mesh) == \
        {"memory": P("model")}
    dp_only = MESHES["8"]
    assert get_backend("robe").param_specs(z3, rules, mesh=dp_only) == \
        {"memory": P()}
    assert get_backend("full").param_specs(spec2d, rules, mesh=dp_only) == \
        {"table": P("data", None)}


def _dlrm_kw(kind, **extra):
    return dict(name="d", arch="dlrm", n_dense=4, bot_mlp=(16, 8),
                top_mlp=(16, 1), embed_dim=8, vocab_sizes=(64, 96, 32),
                embedding=kind, robe_size=512, robe_block=8, **extra)


CFGS = [(k, {}) for k in BACKENDS] + [("full", {"full_table_shard": "2d"}),
                                      ("robe", {"robe_shard_model": True})]


def _pair(kind, extra):
    jcfg = jrec.RecsysConfig(**_dlrm_kw(kind, **extra),
                             compute_dtype=jnp.float32)
    tcfg = trec.RecsysConfig(**_dlrm_kw(kind, **extra))
    jp = jrec.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _as_2d(spec):
    """The spec that JAX's ``table_2d=True`` makes of ``spec``."""
    return dataclasses.replace(spec, placement="2d")


@pytest.mark.parametrize("kind,extra", CFGS,
                         ids=[f"{k}-{'-'.join(e) or 'default'}"
                              for k, e in CFGS])
def test_recsys_state_and_train_state_specs_match_jax(kind, extra):
    jcfg, tcfg, jp, tp = _pair(kind, extra)
    for name in ("2x4", "2x2", "pod", "8"):
        pod = name == "pod"
        m = MESHES[name]
        jspec = jps.recsys_specs(jp, jdist.default_rules(pod),
                                 embedding_spec=jcfg.embedding_spec(),
                                 mesh=m)
        tspec = tps.recsys_specs(tp, tdist_api.default_rules(pod),
                                 embedding_spec=tcfg.embedding_spec(),
                                 mesh=m)
        _same(jspec, tspec, name)
        _same(jdist.prune_specs(jspec, jp, m),
              tdist_api.prune_specs(tspec, tp, m), name)
        # JAX's table_2d knob is the port's placement="2d" spec
        _same(jps.recsys_specs(jp, jdist.default_rules(pod),
                               embedding_spec=jcfg.embedding_spec(),
                               table_2d=True, mesh=m),
              tps.recsys_specs(tp, tdist_api.default_rules(pod),
                               embedding_spec=_as_2d(tcfg.embedding_spec()),
                               mesh=m), name)
        _same(jps.replicated_specs(jp), tps.replicated_specs(tp))
        for okw in (dict(kind="adagrad"), dict(kind="adam"),
                    dict(kind="sgd", momentum=0.9), dict(kind="sgd"),
                    dict(kind="adafactor")):
            jo = jopt.make_optimizer(jopt.OptimizerConfig(**okw)).init(jp)
            to = topt.make_optimizer(topt.OptimizerConfig(**okw)).init(tp)
            _same(jps.state_specs(jspec, jo), tps.state_specs(tspec, to),
                  f"{name}/{okw}")
            jstate = {"params": jp, "opt": jo, "step": jnp.zeros((),
                                                                 jnp.int32),
                      "ef": jax.tree.map(lambda p: jnp.zeros((2,) + p.shape),
                                         jp)}
            tstate = {"params": tp, "opt": to, "step": torch.zeros(()),
                      "ef": {k: v for k, v in params_from_numpy(
                          jax.tree.map(np.asarray, jstate["ef"]),
                          "cpu").items()}}
            for rules in (None, (jdist.default_rules(pod),
                                 tdist_api.default_rules(pod))):
                _same(jel.train_state_specs(jstate, jspec,
                                            rules and rules[0]),
                      tel.train_state_specs(tstate, tspec,
                                            rules and rules[1]),
                      f"{name}/{okw}/train_state")
    with pytest.raises(ValueError, match="embedding_spec"):
        tps.recsys_specs(tp, tdist_api.default_rules())


def test_train_state_specs_shards_error_feedback_over_data():
    """tests/test_elastic.py's case on the port."""
    state = {"params": {"w": torch.zeros((4, 4))},
             "opt": {"m": {"w": torch.zeros((4, 4))}},
             "step": torch.zeros((), dtype=torch.int32),
             "ef": {"w": torch.zeros((2, 4, 4))}}
    pspecs = {"w": P(None, "model")}
    specs = tel.train_state_specs(state, pspecs,
                                  tdist_api.default_rules())
    assert specs["params"] == pspecs
    assert specs["opt"]["m"]["w"] == P(None, "model")
    assert specs["step"] == P()
    assert specs["ef"]["w"] == P("data")
    assert tel.train_state_specs(state, pspecs)["ef"]["w"] == P()


def _ranked_ctx(shape, names, coords):
    m = _mesh(shape, names)
    m.coords = dict(zip(names, coords))
    return tdist_api.DistContext(mesh=m, rules=tdist_api.default_rules())


def test_cut_rows_and_global_shapes():
    """``Sharding.cut`` takes the rank's block where a jax
    ``NamedSharding`` puts it (data-major, then model), and
    ``batch_rows`` the rank's ``flat_batch`` rows."""
    x = torch.arange(16 * 3).reshape(16, 3)
    jm = jax.make_mesh((2, 4), ("data", "model"))
    for spec in ((("data", "model"), None), ("model",), ("data",),
                 (None, None)):
        arr = jax.device_put(np.asarray(x), jax.sharding.NamedSharding(
            jm, JP(*spec)))
        for shard in arr.addressable_shards:
            d = list(jm.devices.flat).index(shard.device)
            ctx = _ranked_ctx((2, 4), ("data", "model"), divmod(d, 4))
            sh = tdist_api.Sharding(ctx, P(*spec))
            got = sh.cut(x)
            assert np.array_equal(got.numpy(), np.asarray(shard.data))
            assert sh.global_shape(got.shape) == tuple(x.shape)
            if spec == (("data", "model"), None):
                assert torch.equal(x[tdist_api.batch_rows(ctx, 16)], got)
    ctx = _ranked_ctx((2, 4), ("data", "model"), (1, 2))
    assert tdist_api.batch_rows(ctx, 16) == slice(12, 14)
    assert tdist_api.batch_rows(ctx, 12) == slice(0, 12)   # 12 % 8
    with pytest.raises(ValueError, match="divide"):
        tdist_api.Sharding(ctx, P("model")).cut(torch.zeros(6))


def test_shard_cuts_the_resolved_layout():
    """``shard`` cuts a replicated tensor to the rank's block of the layout
    its logical axes resolve to (JAX's ``with_sharding_constraint`` on the
    same spec); ``shard_if_divisible`` keeps a dim whole that does not
    divide; both are no-ops outside a context."""
    x = torch.arange(16 * 6).reshape(16, 6)
    assert tdist_api.shard(x, "flat_batch", None) is x
    ctx = _ranked_ctx((2, 2), ("data", "model"), (1, 0))
    with tdist_api.use(ctx):
        assert torch.equal(tdist_api.shard(x, "flat_batch", None),
                           x[8:12])
        assert torch.equal(tdist_api.shard(x, "batch", "mlp"),
                           x[8:16, 0:3])
        assert torch.equal(tdist_api.shard(x, None, "embed"), x)
        y = x[:6]
        assert torch.equal(tdist_api.shard_if_divisible(
            y, ("flat_batch", "mlp")), y[:, 0:3])      # 6 % 4: rows whole


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def _oracle(gs, rs, method):
    """repro.train.compression's formulas in numpy, over ranks' grads."""
    n = len(gs)
    if method == "bf16":
        gf = [g + r for g, r in zip(gs, rs)]
        q = [torch.from_numpy(x).to(torch.bfloat16) for x in gf]
        new_r = [x - qq.float().numpy() for x, qq in zip(gf, q)]
        tot = q[0].float()
        for qq in q[1:]:
            tot = (tot + qq.float()).to(torch.bfloat16).float()
        return tot.numpy() / n, new_r
    gf = [(g + r).astype(np.float32) for g, r in zip(gs, rs)]
    scale = np.float32(max(max(np.float32(np.max(np.abs(x))),
                               np.float32(1e-12)) / np.float32(127.0)
                           for x in gf))
    q = [np.clip(np.round(x / scale), -127, 127).astype(np.int8) for x in gf]
    new_r = [x - qq.astype(np.float32) * scale for x, qq in zip(gf, q)]
    tot = np.sum([qq.astype(np.int32) for qq in q], axis=0)
    return tot.astype(np.float32) * scale / np.float32(n), new_r


@pytest.mark.parametrize("method", ["bf16", "int8"])
def test_compression_formulas_on_four_ranks(method):
    rs = np.random.RandomState(3)
    gs = [(rs.randn(8, 64) * 1e-3).astype(np.float32) for _ in range(4)]
    res = [(rs.randn(8, 64) * 1e-6).astype(np.float32) for _ in range(4)]
    want, want_r = _oracle(gs, res, method)
    g = [torch.from_numpy(x) for x in gs]
    r = [torch.from_numpy(x) for x in res]
    scale = None
    if method == "int8":
        scale = torch.stack([tcomp.local_scale(a, b)
                             for a, b in zip(g, r)]).max()
    pay = [tcomp.quantize(a, b, method, scale) for a, b in zip(g, r)]
    if method == "bf16":
        tot = pay[0][0]
        for q, _ in pay[1:]:
            tot = tot + q                       # bf16 sum, one rounding
        got = tot.float() / 4
    else:
        tot = sum(q.to(torch.int32) for q, _ in pay)
        got = tot.float() * scale / 4
    np.testing.assert_array_equal(got.numpy(), want)
    for (_, nr), w in zip(pay, want_r):
        np.testing.assert_array_equal(nr.numpy(), w)
    # the bookkeeping is exact: payload + residual == g + r, rank by rank
    for (q, nr), a, b in zip(pay, g, r):
        deq = q.float() if method == "bf16" else q.float() * scale
        assert torch.equal(deq + nr, a + b)


@pytest.fixture(scope="module")
def one_rank_world(tmp_path_factory):
    path = tmp_path_factory.mktemp("pg") / "store"
    tdist.init_process_group("gloo", init_method=f"file://{path}", rank=0,
                             world_size=1, timeout=timedelta(seconds=60))
    try:
        mesh = tmesh.make_mesh((1,), ("data",), device="cpu")
        yield tdist_api.DistContext(mesh=mesh,
                                    rules=tdist_api.default_rules())
    finally:
        tdist.destroy_process_group()


@pytest.mark.parametrize("method", ["none", "bf16", "int8"])
def test_compressed_psum_matches_jax_on_one_device(method, one_rank_world):
    rs = np.random.RandomState(0)
    g = {"w": (rs.randn(1, 8, 64) * 1e-3).astype(np.float32),
         "b": (rs.randn(1, 5) * 1e-2).astype(np.float32)}
    r = {k: (rs.randn(*v.shape) * 1e-6).astype(np.float32)
         for k, v in g.items()}
    jm = jax.make_mesh((1,), ("data",))

    def body(gg, rr):
        gg = jax.tree.map(lambda x: x[0], gg)
        rr = jax.tree.map(lambda x: x[0], rr)
        out, nr = j_compressed_psum(gg, rr, ("data",), method)
        return (jax.tree.map(lambda x: x[None], out),
                jax.tree.map(lambda x: x[None], nr))

    f = jax.shard_map(body, mesh=jm, in_specs=(JP("data"), JP("data")),
                      out_specs=(JP("data"), JP("data")), check_vma=False)
    jout, jres = jax.jit(f)(g, r)
    tg = {k: torch.from_numpy(v[0]) for k, v in g.items()}
    tr = {k: torch.from_numpy(v[0]) for k, v in r.items()}
    out, res = tcomp.compressed_psum(tg, tr, ("data",), method,
                                     one_rank_world)
    for k in g:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k][0]))
        if method == "int8":
            # XLA may fuse gf - q·scale into one rounding: the residuals
            # agree within one rounding of q·scale
            scale = np.abs(g[k] + r[k]).max() / 127
            np.testing.assert_allclose(res[k].numpy(), np.asarray(
                jres[k][0]), rtol=0, atol=127 * scale * 2.0 ** -23)
        else:
            np.testing.assert_array_equal(res[k].numpy(),
                                          np.asarray(jres[k][0]))
    with pytest.raises(ValueError, match="unknown compression"):
        tcomp.compressed_psum(tg, tr, ("data",), "fp8", one_rank_world)


def test_cuda_mesh_without_a_card_raises(one_rank_world):
    """No fallback hides the device: a cuda mesh needs a card, and a cpu
    mesh needs gloo."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_mesh((1,), ("data",))
    with pytest.raises(ValueError, match="ranks"):
        tmesh.make_mesh((2,), ("data",), device="cpu")
    with pytest.raises(ValueError, match="256 ranks"):
        tmesh.make_production_mesh(device="cpu")
