"""RecSys models (PyTorch port of ``repro.models.recsys``): DLRM, AutoInt,
xDeepFM, DeepFM, DCN, FiBiNET and the two-tower retrieval model.

All share the embedding front-end (``EmbeddingSpec`` + a registered
``EmbeddingBackend``) and differ in the interaction op.  Batch layout:
dense features [B, n_dense] float, sparse ids [B, F] int32, labels [B]
(for ``loss_fn``), all tensors on the model's device.  Outputs are logits
[B] (CTR models) or retrieval scores [B, n_candidates] (two-tower).

Under an active ``repro_torch.dist`` context the entry points keep the
JAX package's global view (``dist.api`` contract point 1): ``forward``,
``loss_fn`` and ``serve_scores`` take the global batch, compute this
rank's ``flat_batch`` rows (the substrate's ``lookup_dist`` cuts the ids
and runs its collectives) and return global results: logits and scores
all-gathered, the mean loss all-reduced.  ``loss_fn``'s gradient is that
of the rank's own mean loss; ``train.train_loop`` turns it into the
global one.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch import tracing
from repro_torch.core.robe import RobeSpec
from repro_torch.dist import api as dist
from repro_torch.dist import collectives as coll
from repro_torch.nn.core import dense_apply, dense_init, mlp_apply, mlp_init
from repro_torch.nn.embeddings import (EmbeddingSpec, embedding_init,
                                       embedding_lookup_dist, get_backend)
from repro_torch.nn.interactions import (autoint_layer_apply,
                                         autoint_layer_init, bilinear_apply,
                                         bilinear_init, cin_apply, cin_init,
                                         cross_net_apply, cross_net_init,
                                         dot_interaction_op, fm_interaction,
                                         senet_apply, senet_init)


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    #: dlrm | autoint | xdeepfm | deepfm | dcn | fibinet | two_tower
    arch: str
    vocab_sizes: Tuple[int, ...]
    embed_dim: int
    n_dense: int = 0
    bot_mlp: Tuple[int, ...] = ()
    top_mlp: Tuple[int, ...] = ()
    dnn: Tuple[int, ...] = ()        # deep branch (deepfm/xdeepfm/dcn/…)
    cin_layers: Tuple[int, ...] = ()
    cross_layers: int = 0
    attn_layers: int = 0
    attn_dim: int = 0
    attn_heads: int = 0
    tower_mlp: Tuple[int, ...] = ()  # two-tower
    n_user_fields: int = 0           # two-tower: first k fields are user side
    # embedding substrate — any registered EmbeddingBackend name
    embedding: str = "robe"
    robe_size: int = 0
    robe_block: int = 32
    robe_shard_model: bool = False   # ZeRO-3 ROBE: array sharded over model,
    # all-gathered per lookup (arrays beyond a replica's memory)
    hashed_buckets: int = 0          # QR remainder buckets (0 = auto)
    tt_rank: int = 0                 # tensor-train core rank (0 = default)
    #: serve path: True takes the fused serve kernel, False the unfused
    #: lookup -> concat -> dot_interaction kernels
    use_kernel: bool = False
    full_table_shard: str = "model"  # "model" | "2d" (rows over the whole
    # mesh: no data-axis all-reduce of the table's gradient)
    compute_dtype: torch.dtype = torch.float32

    def embedding_spec(self) -> EmbeddingSpec:
        robe = None
        if self.robe_size > 0:
            robe = RobeSpec(size=self.robe_size, block_size=self.robe_block,
                            seed=11)
        placement = "default"
        if self.robe_shard_model:
            placement = "model"
        elif self.full_table_shard == "2d":
            placement = "2d"
        return EmbeddingSpec(vocab_sizes=self.vocab_sizes,
                             dim=self.embed_dim, kind=self.embedding,
                             robe=robe, placement=placement,
                             hashed_buckets=self.hashed_buckets,
                             tt_rank=self.tt_rank)

    @property
    def n_fields(self) -> int:
        return len(self.vocab_sizes)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: RecsysConfig, generator: torch.Generator,
                device) -> dict:
    """Random parameters in the JAX package's tree ({"embedding": {...}}
    and the arch's layers).  Draws come from ``generator`` in the order of
    the JAX package's keys (other numbers than ``jax.random`` gives for
    the same seed)."""
    spec = cfg.embedding_spec()
    # the full table's rows padded to a multiple of 512, as the JAX
    # package pads them to row-shard evenly, so its params load leaf for
    # leaf
    p: dict = {"embedding": embedding_init(generator, spec, device,
                                           pad_rows_to=512)}
    f, d = cfg.n_fields, cfg.embed_dim
    a = cfg.arch
    if a == "dlrm":
        p["bot"] = mlp_init(generator, (cfg.n_dense,) + cfg.bot_mlp, device)
        n_pairs = (f + 1) * f // 2          # F embeddings + bottom output
        p["top"] = mlp_init(generator, (cfg.bot_mlp[-1] + n_pairs,)
                            + cfg.top_mlp, device)
    elif a == "autoint":
        p["attn"] = [autoint_layer_init(
            generator, d if i == 0 else cfg.attn_dim * cfg.attn_heads,
            cfg.attn_dim, cfg.attn_heads, device)
            for i in range(cfg.attn_layers)]
        p["out"] = dense_init(generator, f * cfg.attn_dim * cfg.attn_heads,
                              1, device)
    elif a == "xdeepfm":
        p["cin"] = cin_init(generator, f, cfg.cin_layers, device)
        p["dnn"] = mlp_init(generator, (f * d,) + cfg.dnn + (1,), device)
        p["cin_out"] = dense_init(generator, sum(cfg.cin_layers), 1, device)
        p["linear"] = dense_init(generator, f * d, 1, device)
    elif a == "deepfm":
        p["dnn"] = mlp_init(generator, (f * d,) + cfg.dnn + (1,), device)
        p["linear"] = dense_init(generator, f * d, 1, device)
    elif a == "dcn":
        p["cross"] = cross_net_init(generator, f * d, cfg.cross_layers,
                                    device)
        p["dnn"] = mlp_init(generator, (f * d,) + cfg.dnn, device)
        p["out"] = dense_init(generator, f * d + cfg.dnn[-1], 1, device)
    elif a == "fibinet":
        p["senet"] = senet_init(generator, f, device)
        p["bilinear"] = bilinear_init(generator, f, d, device)
        p["bilinear2"] = bilinear_init(generator, f, d, device)
        n_bi = f * (f - 1) // 2 * d
        p["dnn"] = mlp_init(generator, (2 * n_bi,) + cfg.dnn + (1,), device)
    elif a == "two_tower":
        in_u = cfg.n_user_fields * d
        in_i = (f - cfg.n_user_fields) * d
        p["user"] = mlp_init(generator, (in_u,) + cfg.tower_mlp, device)
        p["item"] = mlp_init(generator, (in_i,) + cfg.tower_mlp, device)
    else:
        raise ValueError(f"unknown recsys arch {a}")
    return p


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _embed(params, cfg: RecsysConfig, sparse_ids: torch.Tensor,
           fields=None) -> torch.Tensor:
    # the substrate owns its distributed lookup (the rank's rows, the
    # collectives): global ids in, this rank's rows out, on the layout of
    # whoever placed the params
    live = dist.live_specs()
    emb = embedding_lookup_dist(params["embedding"], cfg.embedding_spec(),
                                sparse_ids, compute_dtype=cfg.compute_dtype,
                                fields=fields,
                                pspec=None if live is None
                                else live["embedding"])
    return emb.to(cfg.compute_dtype)


def _batch_emb(params, cfg: RecsysConfig, batch: dict) -> torch.Tensor:
    """[B, F, dim] field embeddings of the rank's rows of ``batch``,
    precomputed or looked up.  A batch carrying ``"emb"`` bypasses the
    substrate lookup (the serving tier's hot-row cache feeds rows this
    way)."""
    emb = batch.get("emb")
    if emb is not None:
        return dist.rows(emb).to(cfg.compute_dtype)
    return _embed(params, cfg, batch["sparse"])


def _batch_size(batch: dict) -> int:
    for k in ("sparse", "emb", "dense"):
        if k in batch:
            return batch[k].shape[0]
    raise KeyError("a batch needs 'sparse', 'emb' or 'dense'")


def _dlrm_interaction(params, cfg: RecsysConfig, batch: dict,
                      bot: torch.Tensor, serve: bool) -> torch.Tensor:
    """[B, (F+1)·F/2] dot-interaction triangle of [bot; field embeddings].

    On the serve path with ``use_kernel`` set, a backend that offers
    ``fused_serve`` (robe) computes lookup -> bag-pool -> gram in one
    kernel.  Everywhere else (and for qrobe, hashed and tt, which decline
    it): the unfused lookup + dot_interaction.
    """
    if serve and cfg.use_kernel and "emb" not in batch:
        spec = cfg.embedding_spec()
        backend = get_backend(spec.kind)
        if backend.fused_serve is not None:
            inter = backend.fused_serve(params["embedding"], spec,
                                        batch["sparse"], bot)
            if inter is not None:
                return inter
    emb = _batch_emb(params, cfg, batch)
    feats = torch.cat([bot[:, None, :], emb], dim=1)
    return dot_interaction_op(feats)


def forward(params, cfg: RecsysConfig, batch: dict,
            serve: bool = False, gather: bool = True) -> torch.Tensor:
    """batch: {"dense": [B,n_dense], "sparse": [B,F]} -> logits [B].

    ``serve`` marks the inference path, where the fused serve kernel may
    engage (DLRM).  A batch may carry precomputed ``"emb"`` [B, F, dim];
    it takes precedence over the substrate lookup and the fused kernel.
    Under a mesh: the global batch in, the global logits out (``gather``
    False: this rank's rows, the output left cut over the mesh as the
    JAX package's jit leaves it).
    """
    out = _forward_rows(params, cfg, batch, serve)
    return dist.gather_rows(out, _batch_size(batch)) if gather else out


def _forward_rows(params, cfg: RecsysConfig, batch: dict,
                  serve: bool = False) -> torch.Tensor:
    """The logits of this rank's rows of the global ``batch``.  A DLRM
    records the spans ``model.bot_mlp``, ``model.interaction`` and
    ``model.top_mlp`` under a profiler (``repro_torch.tracing``)."""
    a = cfg.arch
    if a == "dlrm":
        with tracing.span("model.bot_mlp"):
            dense = dist.rows(batch["dense"]).to(cfg.compute_dtype)
            bot = mlp_apply(params["bot"], dense, final_act=torch.relu)
        with tracing.span("model.interaction"):
            inter = _dlrm_interaction(params, cfg, batch, bot, serve)
        with tracing.span("model.top_mlp"):
            top_in = torch.cat([bot, inter], dim=-1)
            return mlp_apply(params["top"], top_in)[:, 0]
    emb = _batch_emb(params, cfg, batch)             # [B,F,D]
    b, f, d = emb.shape
    flat = emb.reshape(b, f * d)
    if a == "autoint":
        x = emb
        for layer in params["attn"]:
            x = autoint_layer_apply(layer, x, cfg.attn_heads)
        return dense_apply(params["out"], x.reshape(b, -1))[:, 0]
    if a == "xdeepfm":
        cin = cin_apply(params["cin"], emb)
        return (dense_apply(params["cin_out"], cin)[:, 0]
                + mlp_apply(params["dnn"], flat)[:, 0]
                + dense_apply(params["linear"], flat)[:, 0])
    if a == "deepfm":
        return (fm_interaction(emb)[:, 0]
                + mlp_apply(params["dnn"], flat)[:, 0]
                + dense_apply(params["linear"], flat)[:, 0])
    if a == "dcn":
        cross = cross_net_apply(params["cross"], flat)
        deep = mlp_apply(params["dnn"], flat, final_act=torch.relu)
        return dense_apply(params["out"],
                           torch.cat([cross, deep], dim=-1))[:, 0]
    if a == "fibinet":
        se = senet_apply(params["senet"], emb)
        bi1 = bilinear_apply(params["bilinear"], emb)
        bi2 = bilinear_apply(params["bilinear2"], se)
        x = torch.cat([bi1, bi2], dim=-1)
        return mlp_apply(params["dnn"], x)[:, 0]
    raise ValueError(f"forward undefined for {a}")


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-6)


def _tower_rows(params, cfg: RecsysConfig, batch: dict
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    emb = _embed(params, cfg, batch["sparse"])
    b = emb.shape[0]
    ku = cfg.n_user_fields
    u = mlp_apply(params["user"], emb[:, :ku].reshape(b, -1))
    v = mlp_apply(params["item"], emb[:, ku:].reshape(b, -1))
    return _l2_normalize(u), _l2_normalize(v)


def tower_vectors(params, cfg: RecsysConfig, batch: dict,
                  gather: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """two-tower: -> (user [B,D], item [B,D]), L2-normalized (``gather``
    as ``forward``'s)."""
    n = _batch_size(batch)
    out = _tower_rows(params, cfg, batch)
    return tuple(dist.gather_rows(x, n) for x in out) if gather else out


def serve_scores(params, cfg: RecsysConfig, batch: dict,
                 gather: bool = True) -> torch.Tensor:
    """Online/bulk inference: logits [B] (CTR) or retrieval scores
    [B, n_candidates] of the queries ``batch["sparse"]`` against the item
    fields' ids ``batch["cand_sparse"]`` (two-tower).  ``gather`` False:
    under a mesh, this rank's rows of the CTR logits and its candidates'
    scores (``forward``'s)."""
    if cfg.arch == "two_tower":
        u, _ = tower_vectors(params, cfg, batch)
        item_fields = tuple(range(cfg.n_user_fields, cfg.n_fields))
        ids = batch["cand_sparse"].reshape(-1, len(item_fields))
        # each rank scores its slice of the candidates (the JAX package
        # shards them over its mesh), then the slices are all-gathered
        cand = _embed(params, cfg, ids, fields=item_fields)
        vi = mlp_apply(params["item"], cand.reshape(cand.shape[0], -1))
        scores = u @ _l2_normalize(vi).T        # [B, rank's candidates]
        if not gather:
            return scores
        return dist.gather_rows(scores, ids.shape[0], dim=1)
    return forward(params, cfg, batch, serve=True, gather=gather)


def loss_fn(params, cfg: RecsysConfig, batch: dict) -> Tuple[torch.Tensor,
                                                             dict]:
    """CTR models: mean binary cross-entropy of the logits against
    ``batch["label"]``, in the JAX package's form ``max(l, 0) - l·y +
    log1p(exp(-|l|))``; returns (loss, {"logloss": loss}).  Two-tower: the
    in-batch sampled softmax of the ×20 user-item cosines, each user's own
    item the gold; returns (loss, {"loss": loss})."""
    if cfg.arch == "two_tower":
        n = _batch_size(batch)
        u, v = _tower_rows(params, cfg, batch)
        # in-batch sampled softmax against every item of the global batch
        logits = (u @ dist.gather_rows(v, n).T) * 20.0
        lse = torch.logsumexp(logits, dim=-1)
        ctx = dist.current()
        lo = 0 if ctx is None else dist.batch_rows(ctx, n).start
        gold = torch.diagonal(logits, offset=lo)
        loss = _global_mean((lse - gold).mean(), n)
        return loss, {"loss": loss}
    logits = _forward_rows(params, cfg, batch)
    y = dist.rows(batch["label"]).to(torch.float32)
    ce = torch.mean(torch.clamp_min(logits, 0) - logits * y
                    + torch.log1p(torch.exp(-torch.abs(logits))))
    ce = _global_mean(ce, _batch_size(batch))
    return ce, {"logloss": ce}


def _global_mean(local: torch.Tensor, n: int) -> torch.Tensor:
    """The global mean loss as the value, the rank's own mean loss as the
    gradient (``dist.api`` contract point 4): the mean of the ranks' means
    when the batch splits, else every rank's own value."""
    ctx = dist.current()
    if ctx is None or not dist.batch_split(ctx, n):
        return local
    total = coll.all_reduce_(local.detach().clone(), ctx,
                             ctx.mesh.axis_names)
    return local + (total / ctx.n_devices - local).detach()


def make_project_fn(cfg: RecsysConfig):
    """Post-optimizer projection for the model's params, or None.

    Backends whose stored parameters are not what the math sees expose
    ``EmbeddingBackend.project``; this lifts it from the embedding subtree
    to the full param dict for ``build_train_step(project=...)``.  Float
    substrates (robe, hashed, tt) return None and the train step skips the
    hook.
    """
    spec = cfg.embedding_spec()
    backend = get_backend(spec.kind)
    if backend.project is None:
        return None

    def project(params):
        return dict(params,
                    embedding=backend.project(params["embedding"], spec))
    return project
