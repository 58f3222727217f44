"""The cells of the dry run (PyTorch port of ``repro.launch.cells``).

A *cell* = (architecture x input shape [x embedding variant]).  ``build``
returns the step function, fake tensors of the global shape and dtype of
every input (``torch._subclasses.fake_tensor``: nothing is allocated;
they stand for the JAX package's ``ShapeDtypeStruct``s) and the input
shardings on the production mesh (``dist.api.named_shardings`` of the
port's ``P`` trees).

``fn`` runs on one rank of the mesh, under ``dist.use(ctx)`` and
``dist.placed(specs)``, which it sets itself: it takes the rank's shards
of the state, the params and the decode caches (``rank_args`` cuts them
by ``in_shardings``), and the batch whole, as every entry point of the
port takes it (``dist.api`` contract point 1: each rank cuts its own
rows; the batch's sharding names the rows the rank computes).  The
args ``fn`` takes whole are ``global_args``.

Shape kinds:
  LM      train   -> the train step (fwd + bwd + optimizer update)
          prefill -> forward(logits_mode="last", collect_cache=True)
          decode  -> decode_step against a seq-sharded KV cache
  RecSys  train   -> the train step; serve -> serve_scores (two-tower:
          tower_vectors); retrieval -> serve_scores; the scores left cut
          over the mesh (``gather=False``), as JAX's jit leaves them
  GNN     train / train_sampled -> the train step (edge-parallel for big
          graphs)

The train steps are ``train.train_loop.build_train_step``'s (the
gradient rule of ``dist.api`` contract point 4 and the NaN guard
included), returning (state, loss) as the JAX cells' steps do.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.configs import get_arch
from repro_torch.dist import api as dist
from repro_torch.dist.api import P
from repro_torch.dist.param_specs import (recsys_specs, replicated_specs,
                                          state_specs, transformer_specs)
from repro_torch.nn.embedding_backends import get_backend
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
from repro_torch.tree import tree_map


@dataclasses.dataclass
class BuiltCell:
    cell_id: str
    fn: Callable
    arg_shapes: Tuple[Any, ...]
    in_shardings: Tuple[Any, ...]
    model_flops_per_step: float        # 6·N·D (dense) / 6·N_active·D (MoE)
    note: str = ""
    skip: Optional[str] = None
    #: the positions of the args ``fn`` takes whole on every rank (the
    #: batch); every other arg is the rank's shard
    global_args: Tuple[int, ...] = ()


def _shardify(ctx, spec_tree):
    return dist.named_shardings(ctx, spec_tree)


def _dp(ctx):
    return ctx.rules.get("batch")


def _pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@contextlib.contextmanager
def _abstract(ctx):
    """Fake tensors (the active fake mode, else a new one) of global
    shapes on the mesh's device: no context is current while the inputs
    are made, so nothing is cut."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = detect_fake_mode()
    with (contextlib.nullcontext() if mode is not None
          else FakeTensorMode()), dist.use(None):
        yield ctx.device


def _sds(shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def _gen():
    return torch.Generator().manual_seed(0)


def _ranked(ctx, specs, fn):
    """``fn`` run on the rank under ``ctx`` with ``specs`` placed."""
    def run(*args):
        with dist.use(ctx), dist.placed(specs):
            return fn(*args)
    return run


def rank_args(cell: BuiltCell) -> Tuple[Any, ...]:
    """The args ``cell.fn`` takes on this rank: each input of
    ``arg_shapes`` cut to the rank's shard by ``in_shardings``, the
    ``global_args`` whole."""
    out = []
    for i, (a, s) in enumerate(zip(cell.arg_shapes, cell.in_shardings)):
        if i in cell.global_args:
            out.append(a)
        else:
            out.append(tree_map(lambda x, sh: x if sh is None else
                                sh.cut(x), a, s))
    return tuple(out)


def _train_step(loss, opt, specs, project=None):
    from repro_torch.train.train_loop import TrainConfig, build_train_step
    step_fn = build_train_step(loss, opt, TrainConfig(), project=project,
                               specs=specs)

    def step(state, batch):
        new, metrics = step_fn(state, batch)
        return new, metrics["loss"]
    return step


def _state(params, opt, pspecs, device):
    state = {"params": params, "opt": opt.init(params),
             "step": _sds((), torch.int32, device)}
    spec = {"params": pspecs, "opt": state_specs(pspecs, state["opt"]),
            "step": P()}
    return state, spec


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

_LM_OPT = {
    # the 1T cell: bf16 moments (memory)
    "kimi-k2-1t-a32b": OptimizerConfig(kind="adam", lr=2e-4,
                                       moment_dtype=torch.bfloat16),
}


def _lm_cfg(arch_id: str, shape: dict, embedding: str):
    bundle = get_arch(arch_id)
    over = {}
    if arch_id == "kimi-k2-1t-a32b":
        over["param_dtype"] = torch.bfloat16   # 1T params: bf16 + FSDP
    if shape["kind"] != "train":
        over["remat"] = False
    return bundle.make_config("full", embedding=embedding, **over)


def _cache_spec(caches, dp):
    """Caches: batch over dp, SEQUENCE over model (the cut the port's
    ``init_cache`` makes under a mesh).  The stacked ``layers`` carry a
    leading L dim; the unrolled ``dense_layers`` do not."""
    def one(c, stacked):
        pre = (None,) if stacked else ()
        return {k: P(*(pre + (dp, "model")
                       + (None,) * (v.dim() - len(pre) - 2)))
                for k, v in c.items()}
    out = {"layers": one(caches["layers"], True)}
    if "dense_layers" in caches:
        out["dense_layers"] = [one(c, False)
                               for c in caches["dense_layers"]]
    return out


def build_lm_cell(arch_id: str, shape_name: str, ctx,
                  embedding: str = "full") -> BuiltCell:
    from repro_torch.models import transformer as T
    bundle = get_arch(arch_id)
    shape = bundle.shapes[shape_name]
    cell_id = f"{arch_id}/{shape_name}[{embedding}]"
    if shape.get("skip"):
        return BuiltCell(cell_id, None, (), (), 0.0, skip=shape["skip"])
    cfg = _lm_cfg(arch_id, shape, embedding)
    fsdp = arch_id == "kimi-k2-1t-a32b"
    dp = _dp(ctx)
    b, t = shape["global_batch"], shape["seq_len"]
    n_active = cfg.active_param_count()

    with _abstract(ctx) as dev:
        params = T.init_params(cfg, _gen(), dev)
        pspecs = transformer_specs(params, ctx.rules, fsdp=fsdp)

        if shape["kind"] == "train":
            opt = make_optimizer(_LM_OPT.get(
                arch_id, OptimizerConfig(kind="adam", lr=3e-4)))
            state, state_spec = _state(params, opt, pspecs, dev)
            batch = {"tokens": _sds((b, t), torch.int32, dev),
                     "labels": _sds((b, t), torch.int32, dev)}
            batch_spec = {"tokens": P(dp, None), "labels": P(dp, None)}
            step = _train_step(lambda p, bt: T.loss_fn(p, cfg, bt), opt,
                               pspecs)
            flops = 6.0 * n_active * b * t
            return BuiltCell(cell_id, _ranked(ctx, None, step),
                             (state, batch),
                             _shardify(ctx, (state_spec, batch_spec)),
                             flops, global_args=(1,))

        if shape["kind"] == "prefill":
            def prefill(params, tokens):
                logits, _, cache = T.forward(params, cfg, tokens,
                                             collect_cache=True,
                                             logits_mode="last")
                return logits, cache

            flops = 2.0 * n_active * b * t
            return BuiltCell(cell_id, _ranked(ctx, pspecs, prefill),
                             (params, _sds((b, t), torch.int32, dev)),
                             _shardify(ctx, (pspecs, P(dp, None))), flops,
                             global_args=(1,))

        # decode: one token against a seq-len KV cache, full to its last
        # slot (a constant position, which the port's decode_step reads
        # as a Python int)
        caches = T.init_cache(cfg, b, t, device=dev)
        cspec = _cache_spec(caches, dp)

        def decode(params, caches, tokens, pos):
            return T.decode_step(params, cfg, caches, tokens, pos)

        flops = 2.0 * n_active * b * 1
        return BuiltCell(
            cell_id, _ranked(ctx, pspecs, decode),
            (params, caches, _sds((b, 1), torch.int32, dev),
             torch.tensor(t - 1, dtype=torch.int32, device=dev)),
            _shardify(ctx, (pspecs, cspec, P(dp, None), P())), flops,
            note=f"serve_step: 1 new token, KV len {t}",
            global_args=(2, 3))


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------

_RS_OPT = {
    "dlrm-rm2": OptimizerConfig(kind="sgd", lr=1.0),        # paper: SGD
    "dlrm-criteo-tb": OptimizerConfig(kind="sgd", lr=1.0),
}


def recsys_optimizer(arch_id: str) -> OptimizerConfig:
    """The optimizer of a recsys cell's train step."""
    return _RS_OPT.get(arch_id, OptimizerConfig(kind="adam", lr=1e-3))


def recsys_config(arch_id: str, embedding: str = "robe",
                  use_kernel: bool = False):
    """The full-width model config of a recsys cell (``full2d``: the full
    table over the whole mesh), in bf16 compute."""
    table_2d = embedding == "full2d"
    return get_arch(arch_id).make_config(
        "full", embedding="full" if table_2d else embedding,
        full_table_shard="2d" if table_2d else "model",
        compute_dtype=torch.bfloat16, use_kernel=use_kernel)


def _recsys_batch(cfg, batch: int, ctx, spec_axes, device):
    shapes = {"sparse": _sds((batch, cfg.n_fields), torch.int32, device)}
    specs = {"sparse": P(spec_axes, None)}
    if cfg.n_dense:
        shapes["dense"] = _sds((batch, cfg.n_dense), torch.float32, device)
        specs["dense"] = P(spec_axes, None)
    shapes["label"] = _sds((batch,), torch.int32, device)
    specs["label"] = P(spec_axes)
    return shapes, specs


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (str(i),))
    elif tree is not None:
        yield path, tree


def build_recsys_cell(arch_id: str, shape_name: str, ctx,
                      embedding: str = "robe",
                      use_kernel: bool = False) -> BuiltCell:
    from repro_torch.models import recsys as R
    bundle = get_arch(arch_id)
    shape = bundle.shapes[shape_name]
    cell_id = f"{arch_id}/{shape_name}[{embedding}]" + \
        ("[kernel]" if use_kernel else "")
    cfg = recsys_config(arch_id, embedding, use_kernel)
    emb_spec = cfg.embedding_spec()
    backend = get_backend(emb_spec.kind)
    dp = _dp(ctx)
    dp_t = (dp,) if isinstance(dp, str) else tuple(dp)
    # local-lookup substrates (robe/hashed/tt) -> batch shards over the
    # WHOLE mesh; the full-table baseline exchanges over model -> dp only
    flat_axes = dp_t + ("model",) if backend.local_batch else dp

    with _abstract(ctx) as dev:
        params = R.init_params(cfg, _gen(), dev)
        pspecs = recsys_specs(params, ctx.rules, embedding_spec=emb_spec)

        # model flops ≈ 2·(dense params)·batch + interaction; embedding is
        # memory-bound: report the dense-compute figure
        dense_params = sum(x.numel() for path, x in _paths(params)
                           if "embedding" not in path)

        if shape["kind"] == "train":
            b = shape["batch"]
            opt = make_optimizer(recsys_optimizer(arch_id))
            state, state_spec = _state(params, opt, pspecs, dev)
            bshape, bspec = _recsys_batch(cfg, b, ctx, flat_axes, dev)
            # quantized substrates (qrobe): the int8 codes take no
            # gradient (the optimizer freezes them) and the backend's
            # post-step projection folds the float update back into them
            step = _train_step(lambda p, bt: R.loss_fn(p, cfg, bt), opt,
                               pspecs, project=R.make_project_fn(cfg))
            flops = 6.0 * dense_params * b
            return BuiltCell(cell_id, _ranked(ctx, None, step),
                             (state, bshape),
                             _shardify(ctx, (state_spec, bspec)), flops,
                             global_args=(1,))

        if shape["kind"] == "serve":
            b = shape["batch"]
            bshape, bspec = _recsys_batch(cfg, b, ctx, flat_axes, dev)
            bshape.pop("label"), bspec.pop("label")
            if cfg.arch == "two_tower":
                fn = lambda params, batch: R.tower_vectors(params, cfg, batch,
                                                           gather=False)
            else:
                # serve_scores marks the inference hot path (serve=True):
                # robe with use_kernel scores through the fused serve kernel
                fn = lambda params, batch: R.serve_scores(params, cfg, batch,
                                                          gather=False)
            flops = 2.0 * dense_params * b
            return BuiltCell(cell_id, _ranked(ctx, pspecs, fn),
                             (params, bshape),
                             _shardify(ctx, (pspecs, bspec)), flops,
                             global_args=(1,))

        # retrieval: 1 query × n candidates
        n_cand = shape["n_candidates"]
        if cfg.arch == "two_tower":
            n_item = cfg.n_fields - cfg.n_user_fields
            bshape = {"sparse": _sds((1, cfg.n_fields), torch.int32, dev),
                      "cand_sparse": _sds((n_cand, n_item), torch.int32,
                                          dev)}
            bspec = {"sparse": P(None, None),
                     "cand_sparse": P("model", None)}  # 1M % 256 ≠ 0
            flops = 2.0 * dense_params * n_cand
            note = "1 query vs 1e6 candidates (batched dot; candidates " \
                "sharded over model)"
        else:
            # CTR archs: score 1M candidate-augmented rows for one user
            bshape, bspec = _recsys_batch(cfg, n_cand, ctx, flat_axes, dev)
            bshape.pop("label"), bspec.pop("label")
            # 1e6 % 256 != 0 -> shard the bulk-scoring batch over model only
            if backend.local_batch:
                bspec = {k: P("model", *([None] * (v.dim() - 1)))
                         for k, v in bshape.items()}
            flops = 2.0 * dense_params * n_cand
            note = "retrieval-scoring as bulk forward over 1e6 rows"
        fn = lambda params, batch: R.serve_scores(params, cfg, batch,
                                                  gather=False)
        return BuiltCell(cell_id, _ranked(ctx, pspecs, fn),
                         (params, bshape),
                         _shardify(ctx, (pspecs, bspec)), flops, note=note,
                         global_args=(1,))


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

GNN_OPT = OptimizerConfig(kind="adam", lr=1e-3)


def build_gnn_cell(arch_id: str, shape_name: str, ctx,
                   embedding: str = "n/a") -> BuiltCell:
    from repro_torch.models import gatedgcn as G
    bundle = get_arch(arch_id)
    shape = bundle.shapes[shape_name]
    cell_id = f"{arch_id}/{shape_name}"
    cfg = bundle.make_config("full", shape=shape_name)
    dp = _dp(ctx)
    opt = make_optimizer(GNN_OPT)
    all_axes = tuple(ctx.mesh.axis_names)

    with _abstract(ctx) as dev:
        params = G.init_params(cfg, _gen(), dev)
        pspecs = replicated_specs(params)
        i32, f32 = torch.int32, torch.float32

        if shape_name == "molecule":
            b, n, e = shape["batch"], shape["n_nodes"], shape["n_edges"]
            bshape = {"nodes": _sds((b, n, 1), f32, dev),
                      "atom_types": _sds((b, n), i32, dev),
                      "edges": _sds((b, e, 2), i32, dev),
                      "labels": _sds((b,), i32, dev),
                      "node_mask": _sds((b, n), i32, dev)}
            bspec = {k: P(dp, *([None] * (v.dim() - 1)))
                     for k, v in bshape.items()}
            n_edges_eff = b * e
        else:
            if shape["kind"] == "train_sampled":
                bn = shape["batch_nodes"]
                f1, f2 = shape["fanouts"]
                n = bn * (1 + f1 + f1 * f2)
                e = bn * f1 + bn * f1 * f2
            else:
                n, e = shape["n_nodes"], shape["n_edges"]
            e_pad = _pad_to(e, 512)
            bshape = {"nodes": _sds((1, n, cfg.d_feat), f32, dev),
                      "edges": _sds((1, e_pad, 2), i32, dev),
                      "labels": _sds((1, n), i32, dev)}
            bspec = {"nodes": P(None, None, None),
                     "edges": P(None, all_axes, None),
                     "labels": P(None, None)}
            if shape["kind"] == "train_sampled":
                bshape["label_mask"] = _sds((1, n), i32, dev)
                bspec["label_mask"] = P(None, None)
            n_edges_eff = e

        state, state_spec = _state(params, opt, pspecs, dev)
        step = _train_step(lambda p, bt: G.loss_fn(p, cfg, bt), opt, pspecs)

    h = cfg.d_hidden
    # per layer: 5 dense [E|N,h]x[h,h] + gather/scatter; fwd+bwd ≈ ×3
    flops = 3.0 * cfg.n_layers * (2.0 * (3 * n_edges_eff) * h * h
                                  + 2.0 * 2 * n_edges_eff * h)
    return BuiltCell(cell_id, _ranked(ctx, None, step), (state, bshape),
                     _shardify(ctx, (state_spec, bspec)), flops,
                     note="edge-parallel message passing"
                     if shape_name != "molecule" else "batch-parallel",
                     global_args=(1,))


def build_cell(arch_id: str, shape_name: str, ctx,
               embedding: str = "default") -> BuiltCell:
    kind = get_arch(arch_id).kind
    if kind == "lm":
        emb = "full" if embedding == "default" else embedding
        return build_lm_cell(arch_id, shape_name, ctx, emb)
    if kind == "recsys":
        emb = "robe" if embedding == "default" else embedding
        return build_recsys_cell(arch_id, shape_name, ctx, emb)
    return build_gnn_cell(arch_id, shape_name, ctx)

