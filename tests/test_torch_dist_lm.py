"""The LM family's distribution pieces that need no second rank, against
the JAX package, in this process.

* ``transformer_specs`` (``fsdp`` off and on, the default and multi-pod
  rules) and ``moe_param_specs`` entry by entry for the five LM bundles'
  smoke variants, as they come and pruned on stand-in meshes (they read
  only ``mesh.axis_names`` and ``mesh.shape``); ``_fsdp_extend`` at a
  small threshold (the smoke leaves are all under 2^20) over each
  bundle's specs, against JAX's over JAX's.
* ``moe.capacity`` rounds halves to even, as JAX's ``int(round(...))``.
* ``init_cache``'s device default: ``cuda``, which raises without a card.
* On a one-rank gloo world: ``all_to_all`` is a counted copy whose
  transpose is one too, and ``Tp`` refuses rules that put heads, mlp,
  vocab and experts on different axes.

``tests/test_torch_dist_lm_ranks.py`` holds the sharded computations on
four ranks.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_arch as j_get_arch
from repro.dist import api as jdist
from repro.dist import param_specs as jps
from repro.models import transformer as jtr
from repro.nn import moe as jmoe
from repro_torch import tree as ttree
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.dist import api as tdist_api
from repro_torch.dist import collectives as coll
from repro_torch.dist import param_specs as tps
from repro_torch.dist.api import P
from repro_torch.dist.tp import Tp
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as ttr
from repro_torch.nn import attention as tattn
from repro_torch.nn import moe as tmoe

LM_ARCHS = ("kimi-k2-1t-a32b", "qwen3-moe-30b-a3b", "minicpm3-4b",
            "qwen3-0.6b", "qwen1.5-32b")
FSDP_MIN = 256


def _mesh(shape, names):
    return types.SimpleNamespace(axis_names=tuple(names),
                                 shape=dict(zip(names, shape)))


MESHES = {False: (_mesh((2, 4), ("data", "model")),
                  _mesh((4, 2), ("data", "model")),
                  _mesh((8,), ("data",))),
          True: (_mesh((2, 2, 4), ("pod", "data", "model")),)}


def _same(j, t, where="") -> None:
    """Two spec trees entry by entry: jax PartitionSpecs against the
    port's P, dicts and lists."""
    if isinstance(j, JP):
        assert isinstance(t, P), (where, j, t)
        assert tuple(j) == tuple(t), (where, j, t)
    elif isinstance(j, dict):
        assert isinstance(t, dict) and set(j) == set(t), (where, j, t)
        for k in j:
            _same(j[k], t[k], f"{where}/{k}")
    else:
        assert isinstance(j, (list, tuple)) and len(j) == len(t), where
        for i, (a, b) in enumerate(zip(j, t)):
            _same(a, b, f"{where}/{i}")


def _shapes(arch: str):
    """(JAX's shape tree of the smoke config's params, the port's
    params of the same config)."""
    jcfg = j_get_arch(arch).make_config("smoke")
    tcfg = t_get_arch(arch).make_config("smoke")
    jshapes = jax.eval_shape(lambda k: jtr.init_params(k, jcfg),
                             jax.random.PRNGKey(0))
    g = torch.Generator()
    g.manual_seed(0)
    return jshapes, ttr.init_params(tcfg, g, "cpu")


@pytest.mark.parametrize("multi_pod", (False, True))
@pytest.mark.parametrize("fsdp", (False, True))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_transformer_specs_match_jax(arch, fsdp, multi_pod):
    jshapes, tparams = _shapes(arch)
    jrules = jdist.default_rules(multi_pod)
    trules = tdist_api.default_rules(multi_pod)
    j = jps.transformer_specs(jshapes, jrules, fsdp=fsdp)
    t = tps.transformer_specs(tparams, trules, fsdp=fsdp)
    _same(j, t)
    for mesh in MESHES[multi_pod]:
        _same(jdist.prune_specs(j, jshapes, mesh),
              tdist_api.prune_specs(t, tparams, mesh), str(mesh.shape))


@pytest.mark.parametrize("multi_pod", (False, True))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_fsdp_extend_matches_jax(arch, multi_pod):
    """``_fsdp_extend`` at a threshold the smoke leaves reach, over each
    bundle's specs, as JAX's extends JAX's own."""
    jshapes, tparams = _shapes(arch)
    jrules = jdist.default_rules(multi_pod)
    dp = jdist.axes_tuple(jrules["batch"])
    j = jax.tree.map(lambda s, leaf: jps._fsdp_extend(s, leaf, dp, FSDP_MIN),
                     jps.transformer_specs(jshapes, jrules), jshapes,
                     is_leaf=lambda x: isinstance(x, JP))
    t = ttree.tree_map(lambda s, leaf: tps._fsdp_extend(s, leaf, dp,
                                                        FSDP_MIN),
                       tps.transformer_specs(
                           tparams, tdist_api.default_rules(multi_pod)),
                       tparams)
    _same(j, t)
    # the threshold cuts: some leaves go over data, the small ones do not
    flat = jax.tree.leaves(j, is_leaf=lambda x: isinstance(x, JP))
    assert any(dp[-1] in jdist.axes_tuple(e) for s in flat for e in s
               if e is not None)
    assert any(all(e is None or dp[-1] not in jdist.axes_tuple(e)
                   for e in s) for s in flat)


@pytest.mark.parametrize("shape,spec,min_size", [
    ((512, 64), (None, "model"), 1 << 10),
    ((64, 512), (), 1 << 10),
    ((3, 64, 64), (None, "model"), 1 << 10),
    ((8, 8), (), 1 << 10),              # under the threshold
    ((32, 32), ("model", "data"), 1),    # no free dim
    ((16, 16), (), 1),                   # ties: the first
])
@pytest.mark.parametrize("dp", [("data",), ("pod", "data"), ()])
def test_fsdp_extend_cases(shape, spec, min_size, dp):
    leaf = np.zeros(shape, np.float32)
    _same(jps._fsdp_extend(JP(*spec), leaf, dp, min_size),
          tps._fsdp_extend(P(*spec), leaf, dp, min_size))


@pytest.mark.parametrize("multi_pod", (False, True))
@pytest.mark.parametrize("n_shared", (0, 1))
def test_moe_param_specs_match_jax(n_shared, multi_pod):
    kw = dict(d_model=16, d_ff=32, n_experts=8, top_k=2, n_shared=n_shared)
    _same(jmoe.moe_param_specs(jmoe.MoeConfig(**kw),
                               jdist.default_rules(multi_pod)),
          tmoe.moe_param_specs(tmoe.MoeConfig(**kw),
                               tdist_api.default_rules(multi_pod)))


@pytest.mark.parametrize("n,cf", [(10, 1.25), (20, 1.25), (12, 1.0),
                                  (3, 1.0), (1, 0.1), (4096, 1.25),
                                  (5, 1.6), (15, 1.0)])
def test_capacity_rounds_as_jax(n, cf):
    """Halves go to even (n·k/E·cf = 2.5 -> 2, 3.5 -> 4), never below 1."""
    cfg = tmoe.MoeConfig(d_model=4, d_ff=4, n_experts=8, top_k=2,
                         capacity_factor=cf)
    want = max(1, int(round(n * cfg.top_k / cfg.n_experts * cf)))
    assert tmoe.capacity(cfg, n) == want
    assert tmoe.capacity(dataclasses.replace(cfg, capacity_factor=2.5),
                         4) == 2
    assert tmoe.capacity(dataclasses.replace(cfg, capacity_factor=3.5),
                         4) == 4


def test_init_cache_defaults_to_cuda():
    """Without a device both ``init_cache``s ask for ``cuda``: on a box
    with no card they raise rather than make CPU caches."""
    tcfg = t_get_arch("qwen3-0.6b").make_config("smoke")
    calls = (lambda: tattn.init_cache(tcfg.attn_cfg(), 2, 4),
             lambda: ttr.init_cache(tcfg, 2, 4)["layers"])
    for call in calls:
        if torch.cuda.is_available():
            assert all(v.is_cuda for v in call().values())
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                call()
    assert ttr.init_cache(tcfg, 2, 4, "cpu")["layers"]["k"].device.type \
        == "cpu"


@pytest.fixture(scope="module")
def one_rank_world(tmp_path_factory):
    import torch.distributed as tdist
    path = tmp_path_factory.mktemp("pg") / "store"
    tdist.init_process_group("gloo", init_method=f"file://{path}", rank=0,
                             world_size=1)
    try:
        yield tdist_api.DistContext(
            mesh=tmesh.make_mesh((1, 1), ("data", "model"), device="cpu"),
            rules=tdist_api.default_rules())
    finally:
        tdist.destroy_process_group()


@pytest.mark.parametrize("split,concat", [(0, 0), (0, 1), (1, 0), (2, 1)])
def test_all_to_all_on_one_rank(one_rank_world, split, concat):
    """One rank's exchange is a copy, counted; its gradient is the
    cotangent (the transposed exchange, a copy too)."""
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    x.requires_grad_(True)
    coll.counts.clear()
    y = coll.all_to_all(x, one_rank_world, "model", split, concat)
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    w = torch.randn(y.shape, generator=torch.Generator().manual_seed(0))
    (g,) = torch.autograd.grad((y * w).sum(), [x])
    assert torch.equal(g, w)
    assert coll.counts["all_to_all"] == 2


def test_tp_refuses_mixed_model_axes(one_rank_world):
    """The LM lays heads, mlp, vocab, experts and the sequence over one set
    of axes: a rules table that parts them raises (no replicated
    fallback)."""
    tp = Tp.of(one_rank_world, 16)
    assert (tp.axes, tp.size, tp.index, tp.dp, tp.sp) == \
        (("model",), 1, 0, ("data",), True)
    ctx = dataclasses.replace(one_rank_world, rules=dict(
        one_rank_world.rules, vocab="data"))
    with pytest.raises(NotImplementedError, match="model axes"):
        Tp.of(ctx, 16)
    with tdist_api.use(ctx), pytest.raises(NotImplementedError):
        tcfg = t_get_arch("qwen3-0.6b").make_config("smoke")
        g = torch.Generator()
        g.manual_seed(0)
        ttr.forward(ttr.init_params(tcfg, g, "cpu"), tcfg,
                    torch.zeros((2, 4), dtype=torch.int32))


def test_jax_lm_specs_shard_the_expected_leaves():
    """Spot checks of the layout itself (qwen3-moe smoke): q/k/v column-
    and o row-parallel with the stack's leading L, expert stacks over
    model, shared experts and norms replicated, the vocab on both ends."""
    _, tparams = _shapes("qwen3-moe-30b-a3b")
    t = tps.transformer_specs(tparams, tdist_api.default_rules())
    a = t["layers"]["attn"]
    assert a["wq"]["w"] == P(None, None, "model")
    assert a["wo"]["w"] == P(None, "model", None)
    assert a["q_norm"]["g"] == P(None, None)
    assert t["layers"]["moe"]["w_gate"] == P(None, "model", None, None)
    assert t["layers"]["moe"]["router"] == P(None, None, None)
    assert t["embed"]["table"] == P("model", None)
    assert t["lm_head"] == P(None, "model")
    j = jps.transformer_specs(jax.eval_shape(lambda k: jtr.init_params(
        k, j_get_arch("qwen3-moe-30b-a3b").make_config("smoke")),
        jax.random.PRNGKey(0)), jdist.default_rules())
    assert tuple(j["layers"]["attn"]["wq"]["w"]) == (None, None, "model")
