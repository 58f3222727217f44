"""The port's LM family and GatedGCN on four gloo ranks against the JAX
package.

One world of four CPU ranks on a (2, 2) ("data", "model") mesh is
spawned once for the file (``world``, with ``test_torch_dist_ranks``'s
``spawn_world``); it runs every case in ``case_table`` and keeps each
case's results (gathered to the global view), which the tests hold to
``repro``: a sharded computation in JAX's global-view semantics must equal
the one-device one (1e-5, f32), and the expert-parallel MoE and the
edge-parallel GatedGCN also equal JAX's own ``shard_map`` bodies on four
forced CPU devices.  The parent computes the JAX references while the
world runs.

* ``lm/*``: the forward's logits, ``loss_fn``'s loss, ce and aux, and
  every gradient leaf (``train_loop.mesh_grads``, gathered) of a GQA
  (qwen3-0.6b), an MLA (minicpm3-4b) and an EP-MoE (qwen3-moe-30b-a3b,
  ``moe_dispatch="ep"``, capacity 8: no slot drops) smoke config on
  ``full`` and ``robe``, with T = 16 (cut along the sequence) and 15
  (not): the GQA config in all four pairs, the others as (full, 16) and
  (robe, 15); qwen3-0.6b with one kv head (the kv heads do not cut with the q
  heads); kimi-k2 (dense MoE dispatch, a dense first layer) at B = 3
  (rows not cut over the data axis).  The EP aux loss is the mean of the
  ranks' token blocks' aux losses, so its reference is ``repro`` with the
  MoE block's aux taken so (``_blocked_aux``).  Params from ``repro``'s
  init, placed by ``transformer_specs``.
* ``decode/*``: a prefill of 8 tokens, ``fill_cache`` into 12 slots (6 a
  rank) and 3 decode steps, bf16 and int8 caches.
* ``step/*``: one adam ``build_train_step`` step with ``transformer_specs``,
  and one with its ``fsdp`` layout at 256 elements (``_fsdp_extend``; the
  smoke leaves are all under 2^20).
* ``moe/*``: ``moe_apply_ep`` on (data, model) tokens at capacity 8 and
  1 (slots dropped); ``a2a``: ``all_to_all`` and its transpose.
* ``gnn/*``: the edge-parallel GatedGCN (8,192 edges, 100 of them -1),
  data-parallel graphs (graph task, node task with ``label_mask``, a
  batch that does not cut), and an edge count that does not divide the
  mesh.
"""

import pickle
import threading
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_dist_ranks import init_world, spawn_world

WORLD = 4
TOL = 1e-5
LM = {"gqa": ("qwen3-0.6b", {}),
      "mla": ("minicpm3-4b", {}),
      "ep": ("qwen3-moe-30b-a3b", dict(moe_dispatch="ep",
                                       capacity_factor=8.0)),
      "kv1": ("qwen3-0.6b", dict(n_kv_heads=1)),
      "dense_moe": ("kimi-k2-1t-a32b", {})}
LOSS_CASES = [("gqa", e, t, 4) for e in ("full", "robe") for t in (16, 15)
              ] + [(k, "full", 16, 4) for k in ("mla", "ep", "kv1")] + \
    [(k, "robe", 15, 4) for k in ("mla", "ep")] + \
    [("dense_moe", "robe", 16, 3)]
DECODE_CASES = [("gqa", "full", "bfloat16"), ("gqa", "robe", "int8"),
                ("mla", "full", "bfloat16"), ("ep", "full", "int8")]
PREFILL, SLOTS, STEPS = 8, 12, 3
STEP_CASES = [("gqa", "full", False), ("ep", "robe", True)]
FSDP_MIN = 256
LR = 1e-3
MOE = dict(d_model=16, d_ff=32, n_experts=8, top_k=2, n_shared=1)
MOE_CAPS = (8.0, 1.0)
GNN_EDGES, GNN_NODES = 8192, 50


# ---------------------------------------------------------------------------
# the cases (run on every rank; torch only)
# ---------------------------------------------------------------------------

def _np(tree):
    from repro_torch.convert import tree_to_numpy
    return tree_to_numpy(tree)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _tcfg(label: str, emb: str, **over):
    from repro_torch.configs import get_arch
    arch, kw = LM[label]
    return get_arch(arch).make_config("smoke", embedding=emb, **kw, **over)


def _placed(ctx, params_np, fsdp: bool = False):
    """``repro``'s params placed by ``transformer_specs``; ``fsdp``: each
    leaf extended as ``fsdp=True`` extends it, at FSDP_MIN elements."""
    from repro_torch.convert import params_from_numpy, params_onto_mesh
    from repro_torch.dist import api as dist
    from repro_torch.dist.param_specs import _fsdp_extend, transformer_specs
    from repro_torch.tree import tree_map
    whole = params_from_numpy(params_np, "cpu")
    specs = transformer_specs(whole, ctx.rules)
    if fsdp:
        specs = tree_map(lambda s, leaf: _fsdp_extend(
            s, leaf, ctx.dp_axes, FSDP_MIN), specs, whole)
    specs = dist.prune_specs(specs, whole, ctx.mesh)
    return params_onto_mesh(params_np, specs, ctx), specs


def _loss_grads(ctx, loss_fn, params, specs):
    """The loss, its metrics, the gathered global gradient of every leaf
    and the collectives of the loss's forward and backward."""
    from repro_torch.dist import api as dist
    from repro_torch.dist import collectives as coll
    from repro_torch.train.train_loop import mesh_grads
    from repro_torch.tree import leaves, leaves_up_to, unflatten
    xs = [p.detach().clone().requires_grad_(True) for p in leaves(params)]
    with dist.use(ctx), dist.placed(specs):
        coll.counts.clear()
        loss, m = loss_fn(unflatten(params, xs))
        gs = torch.autograd.grad(loss, xs, allow_unused=True)
        counts = dict(coll.counts)
        gs = [torch.zeros_like(x) if g is None else g
              for g, x in zip(gs, xs)]
        g, _ = mesh_grads(ctx, gs, leaves_up_to(params, specs))
        grads = dist.gather(unflatten(params, g), specs, ctx)
    return (float(loss), {k: float(v) for k, v in m.items()}, _np(grads),
            counts)


def case_lm(ctx, inputs, label, emb, t, b):
    from repro_torch.dist import api as dist
    from repro_torch.dist import collectives as coll
    from repro_torch.models import transformer as T
    cfg = _tcfg(label, emb)
    params, specs = _placed(ctx, inputs["lm_params"][(label, emb)])
    batch = {k: _t(v) for k, v in inputs["lm_batch"][(t, b)].items()}
    with dist.use(ctx), dist.placed(specs), torch.no_grad():
        coll.counts.clear()
        logits, aux = T.forward(params, cfg, batch["tokens"])
        fwd = dict(coll.counts)
    loss, m, grads, counts = _loss_grads(
        ctx, lambda p: T.loss_fn(p, cfg, batch), params, specs)
    return {"logits": _np(logits), "aux": float(aux), "loss": loss,
            "metrics": m, "grads": grads, "counts": counts,
            "forward_counts": fwd}


def case_decode(ctx, inputs, label, emb, cache):
    from repro_torch.dist import api as dist
    from repro_torch.dist import collectives as coll
    from repro_torch.models import transformer as T
    cfg = _tcfg(label, emb, cache_dtype=getattr(torch, cache))
    params, specs = _placed(ctx, inputs["lm_params"][(label, emb)])
    toks = _t(inputs["decode_tokens"])
    out = {"logits": [], "counts": []}
    with dist.use(ctx), dist.placed(specs), torch.no_grad():
        last, _, pre = T.forward(params, cfg, toks[:, :PREFILL],
                                 collect_cache=True, logits_mode="last")
        caches = T.init_cache(cfg, toks.shape[0], SLOTS)
        out["cache_shape"] = tuple(caches["layers"][next(iter(
            caches["layers"]))].shape)
        T.fill_cache(cfg, caches, pre, PREFILL)
        for t in range(PREFILL, PREFILL + STEPS):
            coll.counts.clear()
            lg, caches = T.decode_step(params, cfg, caches,
                                       toks[:, t:t + 1], t)
            out["counts"].append(dict(coll.counts))
            out["logits"].append(_np(lg))
    out["last"] = _np(last)
    return out


def case_step(ctx, inputs, label, emb, fsdp):
    from repro_torch.dist import api as dist
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_loop as tl
    from repro_torch.train.elastic import train_state_specs
    cfg = _tcfg(label, emb)
    params, specs = _placed(ctx, inputs["lm_params"][(label, emb)], fsdp)
    opt = topt.make_optimizer(topt.OptimizerConfig(kind="adam", lr=LR))
    tc = tl.TrainConfig()
    batch = {k: _t(v) for k, v in inputs["lm_batch"][(16, 4)].items()}
    with dist.use(ctx):
        step = tl.build_train_step(lambda p, b: T.loss_fn(p, cfg, b), opt,
                                   tc, specs=specs)
        state, m = step(tl.init_state(params, opt, tc, specs=specs), batch)
        sspecs = train_state_specs(state, specs, ctx.rules)
        whole = dist.gather(state, sspecs, ctx)
    sharded = sum(1 for s in _leaves_p(specs) if any(
        e is not None for e in s))
    return {"loss": float(m["loss"]), "state": _np(whole),
            "sharded_leaves": sharded,
            "data_sharded": sum(1 for s in _leaves_p(specs)
                                if "data" in [e for e in s])}


def _leaves_p(specs):
    from repro_torch.dist.api import P
    from repro_torch.tree import leaves
    return [s for s in leaves(specs) if isinstance(s, P)]


def case_moe(ctx, inputs, cap):
    """``moe_apply_ep`` on the rank's block of 64 tokens over (data,
    model): the gathered output and aux, and the gradient of the sum of
    the squared outputs (every rank's share summed: times n)."""
    import dataclasses

    from repro_torch.convert import params_from_numpy
    from repro_torch.dist import api as dist
    from repro_torch.dist import collectives as coll
    from repro_torch.nn import moe as tmoe
    from repro_torch.train.train_loop import mesh_grads
    from repro_torch.tree import leaves, leaves_up_to, unflatten
    cfg = dataclasses.replace(tmoe.MoeConfig(**MOE, dispatch="ep"),
                              capacity_factor=cap)
    axes = ("data", "model")
    specs = tmoe.moe_param_specs(cfg, ctx.rules)
    params = dist.place(params_from_numpy(inputs["moe_params"], "cpu"),
                        specs, ctx)
    x = dist.Sharding(ctx, dist.P(axes, None)).cut(_t(inputs["moe_x"]))
    xs = [p.detach().clone().requires_grad_(True) for p in leaves(params)]
    coll.counts.clear()
    y, aux = tmoe.moe_apply_ep(unflatten(params, xs), cfg, x, ctx,
                               ("model",), axes)
    gs = torch.autograd.grad((y ** 2).sum(), xs)
    counts = dict(coll.counts)
    g, _ = mesh_grads(ctx, list(gs), leaves_up_to(params, specs))
    grads = dist.gather(unflatten(params, [v * ctx.n_devices for v in g]),
                        specs, ctx)
    y = coll.all_gather(y.detach(), ctx, axes)
    return {"y": _np(y), "aux": float(aux), "grads": _np(grads),
            "counts": counts, "capacity": tmoe.capacity(cfg, x.shape[0])}


def case_a2a(ctx, inputs):
    """``all_to_all`` over model (split 0, concat 1) and over the whole
    mesh (split 1, concat 0), and the gradient of a weighted sum through
    the first (its transpose: the swapped exchange)."""
    from repro_torch.dist import collectives as coll
    rank = ctx.index(("data", "model"))
    x = torch.arange(4 * 8, dtype=torch.float32).reshape(4, 8) + 100 * rank
    x.requires_grad_(True)
    y = coll.all_to_all(x, ctx, "model", split_dim=0, concat_dim=1)
    w = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape) \
        * (rank + 1)
    (g,) = torch.autograd.grad((y * w).sum(), [x])
    z = coll.all_to_all(x.detach(), ctx, ("data", "model"), split_dim=1,
                        concat_dim=0)
    return {"rank": rank, "model": ctx.index(("model",)), "y": _np(y),
            "w": _np(w), "g": _np(g), "z": _np(z)}


def _gnn(ctx, inputs, name):
    from repro_torch.configs import get_arch
    from repro_torch.convert import params_from_numpy
    from repro_torch.dist import api as dist
    from repro_torch.dist import collectives as coll
    from repro_torch.dist.param_specs import replicated_specs
    from repro_torch.models import gatedgcn as G
    shape = "molecule" if name.startswith("molecule") else "full_graph_sm"
    cfg = get_arch("gatedgcn").make_config("smoke", shape=shape)
    params = params_from_numpy(inputs["gnn_params"][shape], "cpu")
    batch = {k: _t(v) for k, v in inputs["gnn_batch"][name].items()}
    with dist.use(ctx), torch.no_grad():
        logits = G.forward(params, cfg, batch)
    loss, _, grads, counts = _loss_grads(
        ctx, lambda p: G.loss_fn(p, cfg, batch), params,
        replicated_specs(params))
    return {"logits": _np(logits), "loss": loss, "grads": grads,
            "counts": counts, "ranks_logits": _np(coll.all_gather(
                logits[None], ctx, ("data", "model")))}


def case_gnn(ctx, inputs, name):
    return _gnn(ctx, inputs, name)


def case_gnn_indivisible(ctx, inputs):
    from repro_torch.configs import get_arch
    from repro_torch.convert import params_from_numpy
    from repro_torch.dist import api as dist
    from repro_torch.models import gatedgcn as G
    cfg = get_arch("gatedgcn").make_config("smoke")
    params = params_from_numpy(inputs["gnn_params"]["full_graph_sm"], "cpu")
    batch = {k: _t(v) for k, v in inputs["gnn_batch"]["edge"].items()}
    batch["edges"] = torch.cat([batch["edges"], batch["edges"][:, :2]], 1)
    try:
        with dist.use(ctx), torch.no_grad():
            G.forward(params, cfg, batch)
    except ValueError as e:
        return {"raised": str(e)}
    return {"raised": None}


def case_table():
    t = {}
    for label, emb, tt, b in LOSS_CASES:
        t[f"lm/{label}/{emb}/{tt}/{b}"] = (case_lm, (label, emb, tt, b))
    for label, emb, cache in DECODE_CASES:
        t[f"decode/{label}/{emb}/{cache}"] = (case_decode,
                                              (label, emb, cache))
    for label, emb, fsdp in STEP_CASES:
        t[f"step/{label}/{emb}/{fsdp}"] = (case_step, (label, emb, fsdp))
    for cap in MOE_CAPS:
        t[f"moe/{cap}"] = (case_moe, (cap,))
    t["a2a"] = (case_a2a, ())
    for name in ("edge", "molecule", "molecule7", "node_mask"):
        t[f"gnn/{name}"] = (case_gnn, (name,))
    t["gnn/indivisible"] = (case_gnn_indivisible, ())
    return t


def _rank_main(rank: int, world: int, tmp: str) -> None:
    import torch.distributed as tdist

    from repro_torch.dist import api as dist
    from repro_torch.launch.mesh import make_mesh
    init_world(rank, world, tmp)
    inputs = pickle.loads(Path(tmp, "inputs.pkl").read_bytes())
    ctx = dist.DistContext(mesh=make_mesh((2, 2), ("data", "model"),
                                          device="cpu"),
                           rules=dist.default_rules())
    out = {}
    for name, (fn, args) in case_table().items():
        try:
            out[name] = fn(ctx, inputs, *args)
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    Path(tmp, f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    tdist.barrier()
    tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent: inputs from repro, the world, the JAX references
# ---------------------------------------------------------------------------

def _jcfg(label: str, emb: str, **over):
    from repro.configs import get_arch
    arch, kw = LM[label]
    return get_arch(arch).make_config("smoke", embedding=emb, **kw, **over)


def _lm_batch(t: int, b: int) -> dict:
    rs = np.random.RandomState(t * 10 + b)
    return {"tokens": rs.randint(0, 512, (b, t)).astype(np.int32),
            "labels": rs.randint(0, 512, (b, t)).astype(np.int32)}


def _gnn_batches() -> dict:
    from repro_torch.data import graphs as tgraphs
    rs = np.random.RandomState(0)
    edges = rs.randint(0, GNN_NODES, (1, GNN_EDGES, 2))
    edges[0, -100:] = -1
    edge = {"nodes": rs.randn(1, GNN_NODES, 12).astype(np.float32),
            "edges": edges.astype(np.int32),
            "labels": rs.randint(0, 4, (1, GNN_NODES)).astype(np.int32)}
    mol = tgraphs.molecule_batch(8, 9, 17, seed=3)
    node = {"nodes": rs.randn(8, 20, 12).astype(np.float32),
            "edges": rs.randint(0, 20, (8, 30, 2)).astype(np.int32),
            "labels": rs.randint(0, 4, (8, 20)).astype(np.int32),
            "label_mask": (rs.rand(8, 20) < 0.3).astype(np.int32)}
    node["edges"][:, -3:] = -1
    return {"edge": edge, "molecule": mol,
            "molecule7": {k: v[:7] for k, v in mol.items()},
            "node_mask": node}


def _inputs() -> dict:
    import jax

    from repro.configs import get_arch
    from repro.core.robe import init_memory
    from repro.models import gatedgcn as jgcn
    from repro.models import transformer as jtr
    from repro.nn import moe as jmoe

    def init(fn, cfg):
        return jax.tree.map(np.asarray, fn(jax.random.PRNGKey(0), cfg))

    lm = {}
    for label, emb, _, _ in LOSS_CASES + [(lb, e, 0, 0) for lb, e, _ in
                                           DECODE_CASES + STEP_CASES]:
        if (label, "full") not in lm:
            lm[(label, "full")] = init(jtr.init_params, _jcfg(label, "full"))
        if emb == "robe" and (label, emb) not in lm:
            # repro's robe tree: the full one's layers and head (the same
            # keys), the embedding from the first key
            ke = jax.random.split(jax.random.PRNGKey(0), 3)[0]
            lm[(label, emb)] = dict(lm[(label, "full")], embed={
                "memory": np.asarray(init_memory(
                    ke, _jcfg(label, emb).robe_spec()))})
    rs = np.random.RandomState(7)
    gnn = {s: init(jgcn.init_params, get_arch("gatedgcn").make_config(
        "smoke", shape=s)) for s in ("full_graph_sm", "molecule")}
    return {"lm_params": lm,
            "lm_batch": {(t, b): _lm_batch(t, b)
                         for _, _, t, b in LOSS_CASES},
            "decode_tokens": rs.randint(0, 512, (4, PREFILL + STEPS)
                                        ).astype(np.int32),
            "moe_params": jax.tree.map(np.asarray, jmoe.moe_init(
                jax.random.PRNGKey(0), jmoe.MoeConfig(**MOE))),
            "moe_x": np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                                  (64, 16))),
            "gnn_params": gnn, "gnn_batch": _gnn_batches()}


def _blocked_aux(b: int, t: int):
    """``repro``'s ``_moe_block`` with the aux loss the mean of the aux
    losses of the token blocks the ranks hold (rows over data when B cuts,
    the sequence over model when T does), as ``moe_apply_ep``'s pmean
    takes it."""
    import jax.numpy as jnp

    from repro.models import transformer as jtr
    from repro.nn import moe as jmoe

    def block(p, cfg, x):
        bb, tt, d = x.shape
        mcfg = cfg.moe_cfg()
        y, _ = jmoe.moe_apply_dense(p, mcfg, x.reshape(bb * tt, d))
        nd = 2 if bb % 2 == 0 else 1
        nm = 2 if tt % 2 == 0 else 1
        xb = x.reshape(nd, bb // nd, nm, tt // nm, d)
        auxes = [jmoe._router(p, mcfg, xb[i, :, j].reshape(-1, d))[2]
                 for i in range(nd) for j in range(nm)]
        return y.reshape(bb, tt, d), jnp.mean(jnp.stack(auxes))
    return pytest.MonkeyPatch.context(), block, jtr


def _jlm(label, emb, t, b, params_np):
    import jax

    from repro.models import transformer as jtr
    cfg = _jcfg(label, emb)
    p = jax.tree.map(jax.numpy.asarray, params_np)
    batch = _lm_batch(t, b)
    mp, block, mod = _blocked_aux(b, t)
    with mp as m:
        if cfg.moe_dispatch == "ep":
            m.setattr(mod, "_moe_block", block)
        (logits, aux), ((loss, metrics), g) = jax.jit(lambda q, bb: (
            jtr.forward(q, cfg, bb["tokens"]), jax.value_and_grad(
                lambda qq: jtr.loss_fn(qq, cfg, bb), has_aux=True)(q)))(
            p, batch)
    return {"logits": np.asarray(logits), "aux": float(aux),
            "loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": jax.tree.map(np.asarray, g)}


def _jdecode(label, emb, cache, params_np, toks):
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as jtr
    cfg = _jcfg(label, emb, cache_dtype=getattr(jnp, cache))
    p = jax.tree.map(jnp.asarray, params_np)
    last, _, pre = jax.jit(lambda q, tk: jtr.forward(
        q, cfg, tk, collect_cache=True, logits_mode="last"))(
        p, jnp.asarray(toks[:, :PREFILL]))
    caches = jtr.init_cache(cfg, toks.shape[0], SLOTS)

    def put(buf, val, seq):
        idx = [slice(None)] * buf.ndim
        idx[seq] = slice(0, PREFILL)
        return buf.at[tuple(idx)].set(val.astype(buf.dtype))

    def fill(c, kv, seq):
        kv = dict(kv)
        if "k_scale" in c:             # as gqa_apply's q8 writes a step
            for n in ("k", "v"):
                val = kv[n].astype(jnp.float32)
                s = jnp.max(jnp.abs(val), axis=-1) / 127.0 + 1e-12
                kv[n] = jnp.clip(jnp.round(val / s[..., None]), -127, 127)
                kv[n + "_scale"] = s
        return {k: put(v, kv[k], seq) for k, v in c.items()}

    caches = {"layers": fill(caches["layers"], pre["layers"], 2),
              **({"dense_layers": [fill(c, kv, 1) for c, kv in zip(
                  caches["dense_layers"], pre["dense_layers"])]}
                 if "dense_layers" in caches else {})}
    step = jax.jit(lambda q, c, tk, pos: jtr.decode_step(q, cfg, c, tk,
                                                         pos))
    out = []
    for t in range(PREFILL, PREFILL + STEPS):
        lg, caches = step(p, caches, jnp.asarray(toks[:, t:t + 1]), t)
        out.append(np.asarray(lg))
    return {"last": np.asarray(last), "logits": out}


def _jstep(label, emb, params_np):
    import jax

    from repro.models import transformer as jtr
    from repro.train import optimizer as jopt
    from repro.train import train_loop as jtl
    cfg = _jcfg(label, emb)
    opt = jopt.make_optimizer(jopt.OptimizerConfig(kind="adam", lr=LR))
    tc = jtl.TrainConfig()
    mp, block, mod = _blocked_aux(4, 16)
    with mp as m:
        if cfg.moe_dispatch == "ep":
            m.setattr(mod, "_moe_block", block)
        step = jtl.build_train_step(lambda p, b: jtr.loss_fn(p, cfg, b), opt,
                                    tc)
        state, metrics = step(jtl.init_state(jax.tree.map(
            jax.numpy.asarray, params_np), opt, tc), _lm_batch(16, 4))
    return {"loss": float(metrics["loss"]),
            "state": jax.tree.map(np.asarray, state)}


def _jmoe(inputs, cap):
    import dataclasses

    import jax
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as JP

    from repro.dist import api as jdist
    from repro.nn import moe as jmoe
    cfg = dataclasses.replace(jmoe.MoeConfig(**MOE, dispatch="ep"),
                              capacity_factor=cap)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    f = jax.shard_map(
        lambda pp, xx: jmoe.moe_apply_ep(pp, cfg, xx,
                                         aux_axes=("data", "model")),
        mesh=mesh, in_specs=(jmoe.moe_param_specs(cfg,
                                                  jdist.default_rules()),
                             JP(("data", "model"), None)),
        out_specs=(JP(("data", "model"), None), JP()))
    p = jax.tree.map(jax.numpy.asarray, inputs["moe_params"])
    x = jax.numpy.asarray(inputs["moe_x"])
    y, aux = jax.jit(f)(p, x)
    g = jax.jit(jax.grad(lambda pp: (f(pp, x)[0] ** 2).sum()))(p)
    yd, _ = jmoe.moe_apply_dense(p, cfg, x)
    # the slots past capacity of each rank's block of 16 tokens
    drops = 0
    for blk in np.split(np.asarray(x), 4):
        _, idx, _ = jmoe._router(p, cfg, jax.numpy.asarray(blk))
        cnt = np.bincount(np.asarray(idx).reshape(-1),
                          minlength=cfg.n_experts)
        cap_n = max(1, int(round(len(blk) * cfg.top_k / cfg.n_experts
                                 * cfg.capacity_factor)))
        drops += int(np.maximum(cnt - cap_n, 0).sum())
    return {"y": np.asarray(y), "aux": float(aux),
            "grads": jax.tree.map(np.asarray, g),
            "dense": np.asarray(yd), "drops": drops}


def _jgnn(name, inputs):
    import jax

    from repro.configs import get_arch
    from repro.models import gatedgcn as jgcn
    shape = "molecule" if name.startswith("molecule") else "full_graph_sm"
    cfg = get_arch("gatedgcn").make_config("smoke", shape=shape)
    p = jax.tree.map(jax.numpy.asarray, inputs["gnn_params"][shape])
    batch = {k: jax.numpy.asarray(v)
             for k, v in inputs["gnn_batch"][name].items()}
    logits, (loss, g) = jax.jit(lambda q, b: (
        jgcn.forward(q, cfg, b), jax.value_and_grad(
            lambda qq: jgcn.loss_fn(qq, cfg, b)[0])(q)))(p, batch)
    return {"logits": np.asarray(logits), "loss": float(loss),
            "grads": jax.tree.map(np.asarray, g)}


def _jgnn_body(inputs):
    """JAX's own edge-parallel body: ``forward`` under a (2, 2) mesh of
    four forced CPU devices."""
    import jax
    from jax.sharding import Mesh

    from repro.configs import get_arch
    from repro.dist import api as jdist
    from repro.models import gatedgcn as jgcn
    cfg = get_arch("gatedgcn").make_config("smoke")
    p = jax.tree.map(jax.numpy.asarray, inputs["gnn_params"]["full_graph_sm"])
    batch = {k: jax.numpy.asarray(v)
             for k, v in inputs["gnn_batch"]["edge"].items()}
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    ctx = jdist.DistContext(mesh=mesh, rules=jdist.default_rules())
    out = {}
    with jdist.use(ctx):
        out["logits"] = np.asarray(jax.jit(
            lambda q, b: jgcn.forward(q, cfg, b))(p, batch))
        odd = dict(batch, edges=jax.numpy.concatenate(
            [batch["edges"], batch["edges"][:, :2]], 1))
        try:
            jgcn.forward(p, cfg, odd)
            out["odd_raised"] = None
        except ValueError as e:
            out["odd_raised"] = str(e)
    return out


def _references(inputs) -> dict:
    ref = {}
    for label, emb, t, b in LOSS_CASES:
        ref[f"lm/{label}/{emb}/{t}/{b}"] = _jlm(
            label, emb, t, b, inputs["lm_params"][(label, emb)])
    for label, emb, cache in DECODE_CASES:
        ref[f"decode/{label}/{emb}/{cache}"] = _jdecode(
            label, emb, cache, inputs["lm_params"][(label, emb)],
            inputs["decode_tokens"])
    for label, emb, fsdp in STEP_CASES:
        if (label, emb) not in ref:
            ref[(label, emb)] = _jstep(label, emb,
                                       inputs["lm_params"][(label, emb)])
    for cap in MOE_CAPS:
        ref[f"moe/{cap}"] = _jmoe(inputs, cap)
    for name in ("edge", "molecule", "molecule7", "node_mask"):
        ref[f"gnn/{name}"] = _jgnn(name, inputs)
    ref["gnn_body"] = _jgnn_body(inputs)
    return ref


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world")
    inputs = _inputs()
    (tmp / "inputs.pkl").write_bytes(pickle.dumps(inputs))
    box = {}

    def ranks():
        try:
            box["ranks"] = spawn_world("test_torch_dist_lm_ranks", tmp,
                                       WORLD, timeout=600.0)
        except BaseException as e:        # re-raised in the main thread
            box["error"] = e

    th = threading.Thread(target=ranks)
    th.start()
    try:
        ref = _references(inputs)
    finally:
        th.join()
    if "error" in box:
        raise box["error"]
    return {"inputs": inputs, "ranks": box["ranks"], "ref": ref}


def _result(world, name, rank=0):
    r = world["ranks"][rank][name]
    if isinstance(r, dict) and "error" in r:
        pytest.fail(f"rank {rank} raised in {name}:\n{r['error']}")
    return r


def _close(want, got, where="") -> None:
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=where)


def _same_tree(want, got, where="") -> None:
    """Leaf by leaf in ``jax.tree`` order (dicts by sorted key)."""
    import jax
    wl = jax.tree_util.tree_leaves_with_path(want)
    gl = jax.tree.leaves(got)
    assert len(wl) == len(gl), where
    for (path, a), b in zip(wl, gl):
        _close(a, b, where + jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label,emb,t,b", LOSS_CASES)
def test_lm_matches_single_device(world, label, emb, t, b):
    """Logits, loss (ce and aux) and every gradient leaf on the mesh
    against ``repro``'s single-device computation; the collectives show
    the layout (sequence cut: reduce-scatters and all-gathers; EP: two
    all_to_alls a MoE layer a pass)."""
    name = f"lm/{label}/{emb}/{t}/{b}"
    r, want = _result(world, name), world["ref"][name]
    _close(want["logits"], r["logits"], "logits")
    _close(want["aux"], r["aux"], "aux")
    _close(want["loss"], r["loss"], "loss")
    for k in ("ce", "aux"):
        _close(want["metrics"][k], r["metrics"][k], k)
    _same_tree(want["grads"], r["grads"], "grad")
    c = r["counts"]
    if t % 2 == 0:
        assert c["reduce_scatter"] > 0 and c["all_gather"] > 0, c
    else:
        assert c.get("reduce_scatter", 0) == 0 and c["all_reduce"] > 0, c
    n_moe = 2 if label == "ep" else 0
    assert c.get("all_to_all", 0) == 4 * n_moe, c
    assert r["forward_counts"].get("all_to_all", 0) == 2 * n_moe
    # every rank returns the same global results
    for rank in range(1, WORLD):
        other = _result(world, name, rank)
        np.testing.assert_array_equal(other["logits"], r["logits"])
        assert other["loss"] == r["loss"]


@pytest.mark.parametrize("label,emb,cache", DECODE_CASES)
def test_decode_on_sequence_cut_caches(world, label, emb, cache):
    """A prefill of 8 tokens handed to 12-slot caches cut along the
    sequence (6 slots a rank, ``fill_cache``), then 3 decode steps: the
    prefill's last logits and every step's against ``repro``'s
    single-device chain on the same caches (int8: written as a decode
    step quantizes them); a step's attention merges over model."""
    name = f"decode/{label}/{emb}/{cache}"
    r, want = _result(world, name), world["ref"][name]
    assert r["cache_shape"][1:3] == (2, SLOTS // 2)
    _close(want["last"], r["last"], "prefill")
    for k, (a, b) in enumerate(zip(want["logits"], r["logits"])):
        _close(a, b, f"step {k}")
    for c in r["counts"]:
        assert c["all_reduce"] > 0, c     # the softmax's merge
        assert c.get("all_to_all", 0) == (4 if label == "ep" else 0), c


@pytest.mark.parametrize("label,emb,fsdp", STEP_CASES)
def test_adam_step_matches_single_device(world, label, emb, fsdp):
    """One adam ``build_train_step`` step on the mesh from ``repro``'s
    params: the loss and the whole train state (params, both moments)
    against ``repro``'s step; ``fsdp`` cuts leaves over data too."""
    import jax
    r = _result(world, f"step/{label}/{emb}/{fsdp}")
    want = world["ref"][(label, emb)]
    _close(want["loss"], r["loss"], "loss")
    _same_tree(want["state"]["opt"], r["state"]["opt"], "opt")
    assert int(r["state"]["step"]) == 1
    # adam moves an element by lr·m̂/(sqrt(v̂) + eps): where |g| is within
    # 1e-6 (100 eps) of 0 that is ill-conditioned (rounding in g moves it
    # by up to lr), so the params are held where the update is not
    grads = jax.tree.leaves(want["state"]["opt"]["m"])
    for g, a, b in zip(grads, jax.tree.leaves(want["state"]["params"]),
                       jax.tree.leaves(r["state"]["params"])):
        ok = np.abs(g) / (1 - 0.9) > 1e-6
        _close(a[ok], b[ok], "params")
    assert r["sharded_leaves"] > 0
    assert (r["data_sharded"] > 0) == fsdp


@pytest.mark.parametrize("cap", MOE_CAPS)
def test_moe_ep_matches_jax_shard_map(world, cap):
    """``moe_apply_ep`` on four ranks against JAX's in ``shard_map`` on
    four forced CPU devices (output, aux, every gradient), and at
    capacity 8 against the dense dispatch; at capacity 1 slots drop."""
    r, want = _result(world, f"moe/{cap}"), world["ref"][f"moe/{cap}"]
    _close(want["y"], r["y"], "y")
    _close(want["aux"], r["aux"], "aux")
    _same_tree(want["grads"], r["grads"], "grad")
    # two out and the return's transpose (the tokens take no gradient)
    assert r["counts"]["all_to_all"] == 3
    if cap == 8.0:
        assert want["drops"] == 0
        _close(want["dense"], r["y"], "dense")
    else:
        assert want["drops"] > 0
        assert np.abs(want["dense"] - r["y"]).max() > TOL


def test_all_to_all_and_its_transpose(world):
    """The exchange against numpy's blocks, and the gradient of
    sum(w · all_to_all(x)) is the swapped exchange of w."""
    rs = [_result(world, "a2a", k) for k in range(WORLD)]
    by = {r["rank"]: r for r in rs}
    for r in rs:
        # the model group: the ranks with this rank's data index
        d = r["rank"] // 2
        grp = [by[2 * d], by[2 * d + 1]]
        xs = [np.arange(32, dtype=np.float32).reshape(4, 8) + 100 * g["rank"]
              for g in grp]
        want = np.concatenate([x[2 * r["model"]:2 * r["model"] + 2]
                               for x in xs], 1)
        np.testing.assert_array_equal(r["y"], want)
        # d/dx_j of sum_i w_i · y_i: rank i's y holds x_j's block i
        gw = np.concatenate([np.split(g["w"], 2, 1)[r["model"]]
                             for g in grp], 0)
        np.testing.assert_array_equal(r["g"], gw)
        xall = [np.arange(32, dtype=np.float32).reshape(4, 8) + 100 * k
                for k in range(WORLD)]
        want_z = np.concatenate([np.split(x, WORLD, 1)[r["rank"]]
                                 for x in xall], 0)
        np.testing.assert_array_equal(r["z"], want_z)


@pytest.mark.parametrize("name", ("edge", "molecule", "molecule7",
                                  "node_mask"))
def test_gatedgcn_matches_single_device(world, name):
    """Logits, loss and every gradient leaf against ``repro`` on one
    device: one graph of 8,192 edges edge-parallel (and its logits
    against JAX's own edge-parallel body), and batches of graphs
    data-parallel (8 and 7 molecules; 8 graphs with a node-task
    ``label_mask``)."""
    r, want = _result(world, f"gnn/{name}"), world["ref"][f"gnn/{name}"]
    _close(want["logits"], r["logits"], "logits")
    _close(want["loss"], r["loss"], "loss")
    _same_tree(want["grads"], r["grads"], "grad")
    c = r["counts"]
    if name == "edge":
        _close(world["ref"]["gnn_body"]["logits"], r["logits"], "body")
        # denom, agg and the edge BN's cnt, s1, s2 of each layer; their
        # transposes but cnt's (no gradient) and the last layer's BN sums
        # (its edge state feeds nothing)
        n = 3                                   # the smoke config's layers
        assert c["all_reduce"] == 5 * n + 4 * n - 2, c
        for k in range(WORLD):              # node state whole everywhere
            np.testing.assert_array_equal(r["ranks_logits"][k],
                                          r["ranks_logits"][0])
    elif name == "molecule7":
        assert c.get("all_gather", 0) == 0, c   # every rank every graph


def test_gatedgcn_edges_that_do_not_divide_raise(world):
    """8,194 edges on four ranks: the port raises as JAX's ``shard_map``
    refuses the same batch."""
    assert world["ref"]["gnn_body"]["odd_raised"]
    for k in range(WORLD):
        assert "do not divide" in _result(world, "gnn/indivisible",
                                          k)["raised"]
