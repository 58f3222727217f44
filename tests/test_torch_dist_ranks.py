"""The port's distribution on four gloo ranks against the JAX package's
single-device results.

One world of four CPU ranks on a (2, 2) ("data", "model") mesh is
spawned once for the file (``world``); it runs every case in ``CASES``
and keeps each case's result (rank 0's gathered tensors; every rank's
where a case checks agreement), and each test compares one case with
``repro``'s single-device computation from the same parameters (a
sharded computation in JAX's global-view semantics must equal the
one-device one), at the JAX tests' sizes: vocabs (64, 96, 32), d = 8,
B = 16 (and the batches 6 and 7 that take the non-divisible paths),
robe_size 512, block 8.

The ranks import no JAX: the parent makes the inputs (``repro``'s params
and batches as numpy, a checkpoint written by ``repro``), writes them to
the world's directory and reads the ranks' results back.  A rank that
raises in a case records its traceback there; a rank that dies or hangs
fails the fixture with its output.
"""

import os
import pickle
import subprocess
import sys
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TESTS = ROOT / "tests"
SRC = ROOT / "src"
WORLD = 4
TOL = 1e-5

KW = dict(name="d", arch="dlrm", n_dense=4, bot_mlp=(16, 8),
          top_mlp=(16, 1), embed_dim=8, vocab_sizes=(64, 96, 32),
          robe_size=512, robe_block=8)
PLACEMENTS = {
    "full": dict(embedding="full"),
    "full-2d": dict(embedding="full", full_table_shard="2d"),
    "robe-z3": dict(embedding="robe", robe_shard_model=True),
    "robe": dict(embedding="robe"),
    "qrobe": dict(embedding="qrobe"),
    "hashed": dict(embedding="hashed"),
    "tt": dict(embedding="tt"),
}
BATCHES = (16, 6, 7)
TOWER = dict(name="t", arch="two_tower", vocab_sizes=(64, 96, 32, 48),
             embed_dim=8, tower_mlp=(16, 8), n_user_fields=2, robe_size=512,
             robe_block=8)
TOWER_PLACEMENTS = ("robe", "full")
N_CAND = (24, 10)
STEP_PLACEMENTS = ("full", "full-2d", "robe-z3", "robe")
COMPRESSED = [(m, p) for m in ("bf16", "int8") for p in ("robe-z3", "robe")]
CKPT_PLACEMENTS = ("robe-z3", "full-2d")
SERVER = dict(vocab_sizes=(64, 96, 32), embed_dim=8, n_dense=4,
              bot_mlp=(16, 8), top_mlp=(16, 1), backends=("full", "robe"),
              cache_capacity=0)
SERVER_PLACEMENTS = ({"full": "model"}, {"full": "2d", "robe": "model"})
LR = 0.1
RESTART_FAULTS = ("write", "batch")


# ---------------------------------------------------------------------------
# the world: spawn, run every case on every rank, collect
# ---------------------------------------------------------------------------

def spawn_world(module: str, tmp: Path, world: int = WORLD,
                timeout: float = 240.0) -> list:
    """Run ``module._rank_main(rank, world, tmp)`` in ``world`` processes
    (gloo, rendezvous through a file in ``tmp``); returns each rank's
    pickled result.  A rank that exits non-zero, or a world that outlives
    ``timeout``, fails with every rank's output."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    procs = []
    for r in range(world):
        code = (f"import sys; sys.path[:0] = [{str(TESTS)!r}, {str(SRC)!r}]"
                f"; import {module} as m; m._rank_main({r}, {world}, "
                f"{str(tmp)!r})")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=str(ROOT), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        outs = [p.communicate()[0] for p in procs]
        pytest.fail("the world hung:\n" + "\n".join(
            f"--- rank {r}\n{o[-3000:]}" for r, o in enumerate(outs)))
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        pytest.fail("ranks failed:\n" + "\n".join(
            f"--- rank {r}\n{outs[r][-3000:]}" for r in bad))
    return [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
            for r in range(world)]


def init_world(rank: int, world: int, tmp: str):
    import torch.distributed as tdist
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                             rank=rank, world_size=world,
                             timeout=timedelta(seconds=60))


def run_cases(cases: dict, rank: int, tmp: str, *args) -> None:
    """Each case on this rank, its result or its traceback kept."""
    out = {}
    for name, fn in cases.items():
        try:
            out[name] = fn(*args)
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    Path(tmp, f"rank{rank}.pkl").write_bytes(pickle.dumps(out))


def _rank_main(rank: int, world: int, tmp: str) -> None:
    import torch.distributed as tdist

    from repro_torch.dist import api as dist
    from repro_torch.launch.mesh import make_mesh
    init_world(rank, world, tmp)
    inputs = pickle.loads(Path(tmp, "inputs.pkl").read_bytes())
    ctx = dist.DistContext(mesh=make_mesh((2, 2), ("data", "model"),
                                          device="cpu"),
                           rules=dist.default_rules())
    cases = {name: (lambda fn, a: lambda: fn(ctx, inputs, tmp, *a))(fn, a)
             for name, (fn, a) in case_table().items()}
    run_cases(cases, rank, tmp)
    tdist.barrier()
    tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# the cases (run on every rank; torch only)
# ---------------------------------------------------------------------------

def _np(tree):
    from repro_torch.convert import tree_to_numpy
    return tree_to_numpy(tree)


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _cfg(kind: str, kw=None):
    from repro_torch.models.recsys import RecsysConfig
    kw = KW if kw is None else kw
    return RecsysConfig(**kw, **PLACEMENTS[kind])


def _placed(ctx, cfg, params_np):
    from repro_torch.convert import params_onto_mesh, params_from_numpy
    from repro_torch.dist import api as dist
    from repro_torch.dist.param_specs import recsys_specs
    whole = params_from_numpy(params_np, "cpu")
    specs = dist.prune_specs(recsys_specs(whole, ctx.rules,
                                          cfg.embedding_spec(),
                                          mesh=ctx.mesh), whole, ctx.mesh)
    return params_onto_mesh(params_np, specs, ctx), specs


def _loss_grads(ctx, cfg, params, specs, batch, counts=None):
    """The loss and the gathered global gradient of every float leaf
    (``counts``: filled with the collectives of the loss's forward and
    backward)."""
    from repro_torch.dist import api as dist
    from repro_torch.dist import collectives as coll
    from repro_torch.models.recsys import loss_fn
    from repro_torch.train.train_loop import mesh_grads
    from repro_torch.tree import leaves, leaves_up_to, unflatten
    flat = leaves(params)
    xs = [p.detach().clone().requires_grad_(p.is_floating_point())
          for p in flat]
    with dist.use(ctx), dist.placed(specs):
        coll.counts.clear()
        loss = loss_fn(unflatten(params, xs), cfg, batch)[0]
        gs = iter(torch.autograd.grad(loss, [x for x in xs
                                             if x.requires_grad]))
        if counts is not None:
            counts.update(coll.counts)
        raw = [next(gs) if x.requires_grad else None for x in xs]
        g, _ = mesh_grads(ctx, raw, leaves_up_to(params, specs))
        grads = dist.gather(unflatten(params, g), specs, ctx)
    return float(loss), _np(grads)


def case_loss_grads(ctx, inputs, tmp, kind, b):
    cfg = _cfg(kind)
    params, specs = _placed(ctx, cfg, inputs["params"][kind])
    counts = {}
    loss, grads = _loss_grads(ctx, cfg, params, specs,
                              _tensors(inputs["batch"][b]), counts)
    return {"loss": loss, "grads": grads, "counts": counts}


def case_whole_table(ctx, inputs, tmp, b):
    """The ``full`` table whole on every rank (``replicated_specs``, the
    layout a degraded mesh that no longer divides the rows leaves): the
    lookups read it from the live specs, not from the backend's own
    row-sharded layout."""
    from repro_torch.convert import params_onto_mesh
    from repro_torch.dist.param_specs import replicated_specs
    cfg = _cfg("full")
    specs = replicated_specs(inputs["params"]["full"])
    params = params_onto_mesh(inputs["params"]["full"], specs, ctx)
    counts = {}
    loss, grads = _loss_grads(ctx, cfg, params, specs,
                              _tensors(inputs["batch"][b]), counts)
    return {"loss": loss, "grads": grads, "counts": counts}


def case_full_body(ctx, inputs, tmp):
    """The port's counterpart of test_full_embedding_sharded_lookup_
    matches_local: the masked gather + reduce-scatter body, its output
    rows and the table's gradient, gathered."""
    from repro_torch.dist import api as dist
    from repro_torch.dist import collectives as coll
    from repro_torch.dist.api import P
    from repro_torch.nn.embeddings import (EmbeddingSpec,
                                           full_lookup_sharded_body)
    spec = EmbeddingSpec(vocab_sizes=(40, 24, 64), dim=8, kind="full")
    table = torch.from_numpy(inputs["body_table"])
    idx = torch.from_numpy(inputs["body_idx"])
    rows = table.shape[0] // ctx.mesh.shape["model"]
    shard = dist.Sharding(ctx, P("model", None)).cut(table)
    shard = shard.clone().requires_grad_(True)
    ix = dist.Sharding(ctx, P("data", None)).cut(idx)
    out = full_lookup_sharded_body(shard, ix, spec.offsets, ctx, rows)
    (g,) = torch.autograd.grad((out ** 2).sum(), [shard])
    g = coll.all_reduce_(g, ctx, ("data",))
    return {"out": _np(dist.gather_rows(out.detach(), idx.shape[0], ctx)),
            "grad": _np(dist.Sharding(ctx, P("model", None)).gather(g))}


def case_tower(ctx, inputs, tmp, kind, n_cand):
    from repro_torch.dist import api as dist
    from repro_torch.models.recsys import RecsysConfig, serve_scores
    cfg = RecsysConfig(**TOWER, **PLACEMENTS[kind])
    params, specs = _placed(ctx, cfg, inputs["tower_params"][kind])
    q = _tensors(inputs["tower_query"][n_cand])
    with dist.use(ctx), torch.no_grad():
        scores = serve_scores(params, cfg, q)
    loss, grads = _loss_grads(ctx, cfg, params, specs,
                              _tensors(inputs["tower_batch"]))
    return {"scores": _np(scores), "loss": loss, "grads": grads}


def _step(ctx, kind, params_np, batches, compression="none"):
    from repro_torch.dist import api as dist
    from repro_torch.models.recsys import loss_fn
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_loop as tl
    from repro_torch.train.elastic import train_state_specs
    cfg = _cfg(kind)
    params, specs = _placed(ctx, cfg, params_np)
    opt = topt.make_optimizer(topt.OptimizerConfig(kind="sgd", lr=LR))
    tc = tl.TrainConfig(grad_compression=compression)
    out = []
    with dist.use(ctx):
        step = tl.build_train_step(lambda p, b: loss_fn(p, cfg, b), opt,
                                   tc, specs=specs)
        state = tl.init_state(params, opt, tc, specs=specs)
        sspecs = train_state_specs(state, specs, ctx.rules)
        for b in batches:
            state, m = step(state, _tensors(b))
            out.append({"loss": float(m["loss"]),
                        "finite": float(m["finite"]),
                        "state": _np(dist.gather(state, sspecs, ctx))})
    return out, state


def case_train_step(ctx, inputs, tmp, kind):
    return _step(ctx, kind, inputs["params"][kind],
                 [inputs["batch"][16]])[0]


def case_compressed(ctx, inputs, tmp, method, kind):
    return _step(ctx, kind, inputs["params"][kind],
                 [inputs["batch"][16], inputs["batch2"]], method)[0]


def case_nan(ctx, inputs, tmp):
    """A NaN in the last rank's rows of the batch: every rank skips the
    update."""
    from repro_torch.dist import api as dist
    b = dict(inputs["batch"][16])
    dense = b["dense"].copy()
    dense[12:16] = np.nan            # rank 3's flat_batch rows
    b["dense"] = dense
    out, state = _step(ctx, "full", inputs["params"]["full"], [b])
    params, _ = _placed(ctx, _cfg("full"), inputs["params"]["full"])
    from repro_torch.tree import leaves
    same = all(torch.equal(a, c) for a, c in
               zip(leaves(state["params"]), leaves(params)))
    rows = dist.batch_rows(ctx, 16)
    return {"finite": out[0]["finite"], "loss": out[0]["loss"],
            "unchanged": same, "poisoned_here": rows.start >= 12}


def case_ckpt_save(ctx, inputs, tmp, kind):
    """One step on the mesh, then ``save`` from the mesh (rank 0 writes
    the global arrays); the gathered state is returned to compare with
    what JAX's ``restore_latest`` reads back."""
    from repro_torch.dist import api as dist
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.elastic import train_state_specs
    out, state = _step(ctx, kind, inputs["params"][kind],
                       [inputs["batch"][16]])
    with dist.use(ctx):
        specs = train_state_specs(state, _placed(
            ctx, _cfg(kind), inputs["params"][kind])[1], ctx.rules)
        ck.save(str(Path(tmp, f"ckpt-port-{kind}")), 1, state,
                shardings=dist.named_shardings(ctx, specs))
    return {"state": out[0]["state"]}


def case_ckpt_restore(ctx, inputs, tmp, kind):
    """``restore_onto`` a checkpoint that ``repro`` wrote, then gather."""
    from repro_torch.dist import api as dist
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.elastic import train_state_specs
    _, state = _step(ctx, kind, inputs["params"][kind],
                     [inputs["batch"][16]])
    specs = train_state_specs(state, _placed(
        ctx, _cfg(kind), inputs["params"][kind])[1], ctx.rules)
    got, man = ck.restore_onto(str(Path(tmp, f"ckpt-jax-{kind}")), state,
                               ctx, specs)
    with dist.use(ctx):
        whole = dist.gather(got, dist.prune_specs(
            specs, dist.global_shapes(got, specs, ctx), ctx.mesh), ctx)
    return {"state": _np(whole), "step": int(man["step"])}


def case_server(ctx, inputs, tmp, k):
    """``EmbeddingServer.score`` under the mesh (every rank the same padded
    global batch), from the JAX server's params; a row-sharded table
    declines the hot-row cache."""
    import dataclasses

    from repro_torch.convert import params_from_numpy
    from repro_torch.dist import api as dist
    from repro_torch.serve.server import EmbeddingServer, ServerConfig
    cfg = ServerConfig(**SERVER)
    params = {b: params_from_numpy(p, "cpu")
              for b, p in inputs["server_params"].items()}
    with dist.use(ctx):
        srv = EmbeddingServer(cfg, params=params, device="cpu",
                              placement=SERVER_PLACEMENTS[k])
        out = {b: srv.score(b, inputs["server_batch"], n_valid=13)
               for b in cfg.backends}
        try:
            EmbeddingServer(dataclasses.replace(cfg, cache_capacity=64),
                            params=params, device="cpu")
            out["cache_refused"] = False
        except ValueError as e:
            out["cache_refused"] = "hot-row cache" in str(e)
    return out


def case_restart(ctx, inputs, tmp, fault):
    """``run`` with checkpoints on the mesh, with a failure on one rank
    only: ``write``, rank 0's checkpoint write of step 4 fails (only rank
    0 writes); ``batch``, rank 3's batch of step 5 raises once; ``none``,
    the clean run.  Every rank must restart with the others, at the same
    step."""
    from repro_torch.dist import api as dist
    from repro_torch.models.recsys import loss_fn
    from repro_torch.train import checkpoint as ck
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_loop as tl
    from repro_torch.train.elastic import train_state_specs
    cfg = _cfg("full")
    params, specs = _placed(ctx, cfg, inputs["params"]["full"])
    opt = topt.make_optimizer(topt.OptimizerConfig(kind="sgd", lr=LR))
    tc = tl.TrainConfig(checkpoint_every=2, max_restarts=2)
    rank = ctx.index(ctx.mesh.axis_names)
    failed_here = []

    def batch_at(step):
        if fault == "batch" and rank == 3 and step == 5 and not failed_here:
            failed_here.append(step)
            raise RuntimeError("a batch lost on one rank")
        return _batch(16, seed=100 + step)

    write = ck._save_snapshot

    def failing_write(ckpt_dir, step, *a, **k):
        if fault == "write" and step == 4 and not failed_here:
            failed_here.append(step)
            raise IOError("disk full")
        return write(ckpt_dir, step, *a, **k)

    ck._save_snapshot = failing_write
    try:
        with dist.use(ctx):
            step = tl.build_train_step(lambda p, b: loss_fn(p, cfg, b), opt,
                                       tc, specs=specs)
            rep = tl.run(tl.init_state(params, opt, tc, specs=specs), step,
                         batch_at, 8, tc,
                         ckpt_dir=str(Path(tmp, f"restart-{fault}")))
            final = dist.gather(rep.state, train_state_specs(
                rep.state, specs, ctx.rules), ctx)
    finally:
        ck._save_snapshot = write
    return {"losses": rep.losses, "restarts": rep.restarts,
            "steps_done": rep.steps_done, "failed_here": bool(failed_here),
            "final": _np(final)}


def case_table():
    t = {}
    for kind in PLACEMENTS:
        for b in BATCHES:
            t[f"loss_grads/{kind}/{b}"] = (case_loss_grads, (kind, b))
    for b in BATCHES:
        t[f"whole_table/{b}"] = (case_whole_table, (b,))
    t["full_body"] = (case_full_body, ())
    for kind in TOWER_PLACEMENTS:
        for n in N_CAND:
            t[f"tower/{kind}/{n}"] = (case_tower, (kind, n))
    for kind in STEP_PLACEMENTS:
        t[f"step/{kind}"] = (case_train_step, (kind,))
    for m, kind in COMPRESSED:
        t[f"compressed/{m}/{kind}"] = (case_compressed, (m, kind))
    t["nan"] = (case_nan, ())
    for k in range(len(SERVER_PLACEMENTS)):
        t[f"server/{k}"] = (case_server, (k,))
    for kind in CKPT_PLACEMENTS:
        t[f"ckpt_save/{kind}"] = (case_ckpt_save, (kind,))
        t[f"ckpt_restore/{kind}"] = (case_ckpt_restore, (kind,))
    for fault in RESTART_FAULTS + ("none",):
        t[f"restart/{fault}"] = (case_restart, (fault,))
    return t


# ---------------------------------------------------------------------------
# the parent: inputs from repro, the world, the JAX references
# ---------------------------------------------------------------------------

def _batch(b: int, seed: int = 0) -> dict:
    rs = np.random.RandomState(seed)
    return {"dense": rs.randn(b, 4).astype(np.float32),
            "sparse": rs.randint(0, 30, (b, 3)).astype(np.int32),
            "label": rs.randint(0, 2, (b,)).astype(np.int32)}


def _jcfg(kind: str, kw=None):
    import jax.numpy as jnp

    from repro.models.recsys import RecsysConfig
    kw = KW if kw is None else kw
    return RecsysConfig(**kw, **PLACEMENTS[kind], compute_dtype=jnp.float32)


def _jparams(cfg):
    import jax
    from repro.models.recsys import init_params
    return jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), cfg))


def _tower_query(n_cand: int) -> dict:
    rs = np.random.RandomState(5)
    return {"sparse": rs.randint(0, 30, (4, 4)).astype(np.int32),
            "cand_sparse": rs.randint(0, 30, (n_cand, 2)).astype(np.int32)}


def _jstate_after(kind: str, params_np):
    """``repro``'s sgd train state after one step on batch 16 (the
    template and contents of the checkpoint it writes)."""
    import jax
    from repro.models.recsys import loss_fn
    from repro.train import optimizer as jopt
    from repro.train import train_loop as jtl
    cfg = _jcfg(kind)
    opt = jopt.make_optimizer(jopt.OptimizerConfig(kind="sgd", lr=LR))
    tc = jtl.TrainConfig()
    step = jtl.build_train_step(lambda p, b: loss_fn(p, cfg, b), opt, tc)
    state, _ = step(jtl.init_state(jax.tree.map(jax.numpy.asarray,
                                                params_np), opt, tc),
                    _batch(16))
    return jax.tree.map(np.asarray, state)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import jax

    from repro.serve.server import EmbeddingServer as JServer
    from repro.serve.server import ServerConfig as JServerConfig
    from repro.train import checkpoint as jck
    tmp = tmp_path_factory.mktemp("world")
    params = {k: _jparams(_jcfg(k)) for k in PLACEMENTS}
    table = np.asarray(jax.random.uniform(
        jax.random.PRNGKey(0), (128, 8), jax.numpy.float32, -0.3, 0.3))
    inputs = {
        "params": params,
        "batch": {b: _batch(b) for b in BATCHES},
        "batch2": _batch(16, seed=1),
        "body_table": table,
        "body_idx": np.random.RandomState(1).randint(
            0, 24, (16, 3)).astype(np.int32),
        "tower_params": {k: _jparams(_jcfg(k, TOWER))
                         for k in TOWER_PLACEMENTS},
        "tower_query": {n: _tower_query(n) for n in N_CAND},
        "tower_batch": {"sparse": np.random.RandomState(6).randint(
            0, 30, (16, 4)).astype(np.int32)},
    }
    jsrv = JServer(JServerConfig(**SERVER))
    inputs["server_params"] = {b: jax.tree.map(np.asarray, jsrv.params(b))
                               for b in SERVER["backends"]}
    inputs["server_batch"] = {k: v for k, v in _batch(16, seed=3).items()
                              if k != "label"}
    inputs["server_scores"] = {b: np.asarray(jsrv.score(
        b, inputs["server_batch"], n_valid=13)) for b in SERVER["backends"]}
    for kind in CKPT_PLACEMENTS:
        # a checkpoint written by repro, restored onto the ranks
        jck.save(str(tmp / f"ckpt-jax-{kind}"), 7,
                 _jstate_after(kind, params[kind]))
    (tmp / "inputs.pkl").write_bytes(pickle.dumps(inputs))
    ranks = spawn_world("test_torch_dist_ranks", tmp)
    return {"tmp": tmp, "inputs": inputs, "ranks": ranks}


def _close(want, got, where="") -> None:
    """Within 1e-5, absolute and relative (the port's tests' tolerance):
    a gradient summed over the ranks adds in another order."""
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=where)


def _result(world, name, rank=0):
    r = world["ranks"][rank][name]
    if isinstance(r, dict) and "error" in r:
        pytest.fail(f"rank {rank} raised in {name}:\n{r['error']}")
    return r


def _jloss_grads(cfg, params_np, batch):
    import jax
    from repro.models.recsys import loss_fn
    p = jax.tree.map(jax.numpy.asarray, params_np)
    loss, g = jax.jit(jax.value_and_grad(lambda q, bb: loss_fn(q, cfg, bb)[0],
                                         allow_int=True))(p, batch)
    return float(loss), g


def _float_leaves(tree):
    import jax
    return [np.asarray(x) for x in jax.tree.leaves(tree)
            if getattr(x, "dtype", None) != jax.dtypes.float0]


def _port_float_grads(grads, params):
    """The port's gradient tree, without the leaves that take none."""
    import jax
    flat, tdef = jax.tree.flatten(grads, is_leaf=lambda x: x is None)
    return [g for g, p in zip(flat, jax.tree.leaves(params))
            if np.issubdtype(np.asarray(p).dtype, np.floating)]


@pytest.mark.parametrize("kind", sorted(PLACEMENTS))
@pytest.mark.parametrize("b", BATCHES)
def test_loss_and_gradients_match_single_device(world, kind, b):
    """Every placement's loss and gathered gradients on the (2, 2) mesh
    against ``repro``'s single-device ``loss_fn`` / ``jax.grad``; B = 16
    splits over the mesh, 6 and 7 take the non-divisible paths."""
    r = _result(world, f"loss_grads/{kind}/{b}")
    params = world["inputs"]["params"][kind]
    loss, g = _jloss_grads(_jcfg(kind), params, _batch(b))
    assert abs(loss - r["loss"]) < TOL
    got = _port_float_grads(r["grads"], params)
    want = _float_leaves(g)
    assert len(got) == len(want)
    for a, c in zip(want, got):
        _close(a, c)
    if kind == "robe-z3":
        # the ZeRO-3 gather ran, and its transpose
        assert r["counts"]["all_gather"] == 1
        assert r["counts"]["reduce_scatter"] == 1
    if kind in ("robe", "qrobe", "hashed", "tt"):
        # replicated: no embedding collective (only the loss's mean)
        assert r["counts"].get("all_gather", 0) == 0
        assert r["counts"].get("reduce_scatter", 0) == 0


@pytest.mark.parametrize("b", BATCHES)
def test_whole_table_under_the_mesh_matches_single_device(world, b):
    """A ``full`` table held whole on every rank, by the live specs: the
    loss and gathered gradients as ``repro``'s on one device, with no
    embedding collective."""
    r = _result(world, f"whole_table/{b}")
    params = world["inputs"]["params"]["full"]
    loss, g = _jloss_grads(_jcfg("full"), params, _batch(b))
    assert abs(loss - r["loss"]) < TOL
    got = _port_float_grads(r["grads"], params)
    want = _float_leaves(g)
    assert len(got) == len(want)
    for a, c in zip(want, got):
        _close(a, c)
    assert r["counts"].get("all_gather", 0) == 0
    assert r["counts"].get("reduce_scatter", 0) == 0


def test_full_sharded_lookup_matches_local(world):
    """The masked gather + reduce-scatter body against ``repro``'s local
    lookup, rows and the table's gradient."""
    import jax

    from repro.nn.embeddings import EmbeddingSpec as JSpec
    from repro.nn.embeddings import embedding_lookup
    r = _result(world, "full_body")
    spec = JSpec(vocab_sizes=(40, 24, 64), dim=8, kind="full")
    table = world["inputs"]["body_table"]
    idx = world["inputs"]["body_idx"]
    want = np.asarray(embedding_lookup({"table": table}, spec, idx))
    assert float(np.max(np.abs(want - r["out"]))) < 1e-6
    gw = np.asarray(jax.grad(lambda t: (embedding_lookup(
        {"table": t}, spec, idx) ** 2).sum())(jax.numpy.asarray(table)))
    assert float(np.max(np.abs(gw - r["grad"]))) < 1e-6


@pytest.mark.parametrize("kind", TOWER_PLACEMENTS)
@pytest.mark.parametrize("n_cand", N_CAND)
def test_retrieval_over_sharded_candidates(world, kind, n_cand):
    """Two-tower scores with each rank scoring its slice of the
    candidates (24 split over the mesh, 10 do not), and the in-batch
    softmax loss and gradients over the global batch."""
    import jax
    from repro.models.recsys import serve_scores
    r = _result(world, f"tower/{kind}/{n_cand}")
    cfg = _jcfg(kind, TOWER)
    params = world["inputs"]["tower_params"][kind]
    want = np.asarray(jax.jit(lambda p, q: serve_scores(p, cfg, q))(
        params, _tower_query(n_cand)))
    assert r["scores"].shape == want.shape
    _close(want, r["scores"])
    loss, g = _jloss_grads(cfg, params, world["inputs"]["tower_batch"])
    assert abs(loss - r["loss"]) < TOL
    for a, c in zip(_float_leaves(g), _port_float_grads(r["grads"],
                                                        params)):
        _close(a, c)


@pytest.mark.parametrize("kind", STEP_PLACEMENTS)
def test_train_step_matches_numpy_oracle(world, kind):
    """One sgd step per placement: the gathered params are the numpy
    update p - lr·g with ``repro``'s single-device gradient."""
    import jax
    r = _result(world, f"step/{kind}")[0]
    params = world["inputs"]["params"][kind]
    loss, g = _jloss_grads(_jcfg(kind), params, _batch(16))
    assert abs(loss - r["loss"]) < TOL and r["finite"] == 1.0
    want = [p - np.float32(LR) * gg for p, gg in
            zip(jax.tree.leaves(params), jax.tree.leaves(g))]
    for a, c in zip(want, jax.tree.leaves(r["state"]["params"])):
        _close(a, c)


def _oracle_compressed(kind, params, batches, method):
    """Two sgd steps with compressed data-axis all-reduce, in numpy: each
    data shard's gradient (``repro``'s single-device gradient of the
    shard's rows: data shard d holds flat rows [8d, 8d + 8)), quantized
    with its residual by compression.py's formulas, averaged."""
    import jax
    p = params
    res = None
    for batch in batches:
        gs = []
        for d in range(2):
            sub = {k: v[8 * d:8 * d + 8] for k, v in batch.items()}
            _, g = _jloss_grads(_jcfg(kind), p, sub)
            gs.append([np.asarray(x) for x in jax.tree.leaves(g)])
        res = res or [[np.zeros_like(x) for x in gs[0]] for _ in range(2)]
        red = []
        for i in range(len(gs[0])):
            gf = [gs[d][i] + res[d][i] for d in range(2)]
            if method == "bf16":
                q = [torch.from_numpy(x).to(torch.bfloat16) for x in gf]
                res_i = [x - qq.float().numpy() for x, qq in zip(gf, q)]
                tot = (q[0] + q[1]).float().numpy()
            else:
                scale = np.float32(max(max(np.max(np.abs(x)), 1e-12)
                                       for x in gf) / np.float32(127.0))
                q = [np.clip(np.round(x / scale), -127, 127) for x in gf]
                res_i = [x - qq.astype(np.float32) * scale
                         for x, qq in zip(gf, q)]
                tot = (q[0] + q[1]).astype(np.float32) * scale
            for d in range(2):
                res[d][i] = res_i[d]
            red.append(tot / 2)
        flat, tdef = jax.tree.flatten(p)
        p = jax.tree.unflatten(tdef, [x - np.float32(LR) * gg
                                      for x, gg in zip(flat, red)])
    return p


@pytest.mark.parametrize("method,kind", COMPRESSED)
def test_compressed_steps_match_numpy_oracle(world, method, kind):
    """Two sgd steps with ``grad_compression`` on the mesh against the
    numpy oracle of the compressed data-axis mean with error feedback."""
    import jax
    r = _result(world, f"compressed/{method}/{kind}")
    inputs = world["inputs"]
    want = _oracle_compressed(kind, inputs["params"][kind],
                              [inputs["batch"][16], inputs["batch2"]],
                              method)
    assert all(s["finite"] == 1.0 for s in r)
    for a, c in zip(jax.tree.leaves(want),
                    jax.tree.leaves(r[-1]["state"]["params"])):
        _close(a, c)
    ef = r[-1]["state"]["ef"]
    assert all(x.shape[0] == 2 for x in jax.tree.leaves(ef))


def test_nan_on_one_ranks_rows_skips_every_update(world):
    rs = [w["nan"] for w in world["ranks"]]
    for rank, r in enumerate(rs):
        if "error" in r:
            pytest.fail(f"rank {rank}:\n{r['error']}")
        assert r["finite"] == 0.0 and not np.isfinite(r["loss"])
        assert r["unchanged"], rank
    assert [r["poisoned_here"] for r in rs] == [False, False, False, True]


@pytest.mark.parametrize("kind", CKPT_PLACEMENTS)
def test_checkpoint_from_four_ranks_restores_in_jax(world, kind):
    """A checkpoint the mesh wrote holds the global arrays: ``repro``'s
    ``restore_latest`` reads them back bit for bit."""
    import jax

    from repro.train import checkpoint as jck
    r = _result(world, f"ckpt_save/{kind}")
    template = _jstate_after(kind, world["inputs"]["params"][kind])
    got, man = jck.restore_latest(str(world["tmp"] / f"ckpt-port-{kind}"),
                                  template)
    assert int(man["step"]) == 1
    for a, c in zip(jax.tree.leaves(got), jax.tree.leaves(r["state"])):
        assert np.array_equal(np.asarray(a), np.asarray(c))


@pytest.mark.parametrize("kind", CKPT_PLACEMENTS)
def test_jax_checkpoint_restores_onto_four_ranks(world, kind):
    """``restore_onto`` cuts a ``repro`` checkpoint into the ranks' shards:
    gathered again, the state is the one JAX wrote, bit for bit."""
    import jax
    r = _result(world, f"ckpt_restore/{kind}")
    want = _jstate_after(kind, world["inputs"]["params"][kind])
    assert r["step"] == 7
    for a, c in zip(jax.tree.leaves(want), jax.tree.leaves(r["state"])):
        assert np.array_equal(np.asarray(a), np.asarray(c))


@pytest.mark.parametrize("fault,at,rewound_to,where", [
    ("write", 6, 2, 0),       # seen at step 6's save; step 4's is missing
    ("batch", 5, 4, 3),
])
def test_one_ranks_failure_restarts_every_rank(world, fault, at, rewound_to,
                                               where):
    """A failure on one rank only (rank 0's checkpoint write, rank 3's
    batch) restarts all four ranks together: each rewinds to the same
    checkpoint, replays the same steps and ends in the same state as the
    clean run."""
    rs = []
    for rank in range(WORLD):
        rs.append(_result(world, f"restart/{fault}", rank))
    clean = _result(world, "restart/none")
    assert [r["failed_here"] for r in rs] == [k == where
                                              for k in range(WORLD)]
    for r in rs:
        assert r["restarts"] == 1
        assert r["losses"] == rs[0]["losses"]
        for a, c in zip(_float_leaves(r["final"]),
                        _float_leaves(rs[0]["final"])):
            assert np.array_equal(a, c)
    want = clean["losses"][:at] + clean["losses"][rewound_to:]
    _close(want, rs[0]["losses"])
    assert rs[0]["steps_done"] == 8
    for a, c in zip(_float_leaves(clean["final"]),
                    _float_leaves(rs[0]["final"])):
        _close(a, c)


@pytest.mark.parametrize("k", range(len(SERVER_PLACEMENTS)))
def test_server_scores_under_the_mesh(world, k):
    """The port's server under the mesh against the JAX server on one
    device, from the same params, padded batch and ``n_valid``."""
    r = _result(world, f"server/{k}")
    for b, want in world["inputs"]["server_scores"].items():
        assert r[b].shape == (13,)
        _close(want, r[b], b)
    assert r["cache_refused"]
