"""RecSys models (PyTorch port of ``repro.models.recsys``; DLRM only).

Batch layout: dense features [B, n_dense] float, sparse ids [B, F] int32,
labels [B] (for ``loss_fn``), all tensors on the model's device.  Outputs
are logits [B].  The other
architectures of the JAX package (autoint, xdeepfm, deepfm, dcn, fibinet,
two_tower) raise until they are ported.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.robe import RobeSpec
from repro_torch.nn.core import mlp_apply, mlp_init
from repro_torch.nn.embeddings import (EmbeddingSpec, embedding_init,
                                       embedding_lookup, get_backend)
from repro_torch.nn.interactions import dot_interaction_op

PORTED_ARCHS = ("dlrm",)


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    arch: str                        # dlrm (others not yet ported)
    vocab_sizes: Tuple[int, ...]
    embed_dim: int
    n_dense: int = 0
    bot_mlp: Tuple[int, ...] = ()
    top_mlp: Tuple[int, ...] = ()
    # embedding substrate — any registered EmbeddingBackend name
    embedding: str = "robe"
    robe_size: int = 0
    robe_block: int = 32
    hashed_buckets: int = 0          # QR remainder buckets (0 = auto)
    tt_rank: int = 0                 # tensor-train core rank (0 = default)
    #: serve path: True takes the fused serve kernel, False the unfused
    #: lookup -> concat -> dot_interaction kernels
    use_kernel: bool = False
    compute_dtype: torch.dtype = torch.float32

    def embedding_spec(self) -> EmbeddingSpec:
        robe = None
        if self.robe_size > 0:
            robe = RobeSpec(size=self.robe_size, block_size=self.robe_block,
                            seed=11)
        return EmbeddingSpec(vocab_sizes=self.vocab_sizes,
                             dim=self.embed_dim, kind=self.embedding,
                             robe=robe, hashed_buckets=self.hashed_buckets,
                             tt_rank=self.tt_rank)

    @property
    def n_fields(self) -> int:
        return len(self.vocab_sizes)


def _check_arch(cfg: RecsysConfig) -> None:
    if cfg.arch not in PORTED_ARCHS:
        raise NotImplementedError(f"recsys arch {cfg.arch!r} is not yet "
                                  f"ported; ported: {PORTED_ARCHS}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: RecsysConfig, generator: torch.Generator,
                device) -> dict:
    """Random parameters in the JAX package's tree: {"embedding": {...},
    "bot": [dense...], "top": [dense...]}.  Draws come from ``generator``
    (other numbers than ``jax.random`` gives for the same seed)."""
    _check_arch(cfg)
    spec = cfg.embedding_spec()
    f = cfg.n_fields
    n_pairs = (f + 1) * f // 2          # F embeddings + bottom output
    return {
        # the full table's rows padded to a multiple of 512, as the JAX
        # package pads them to row-shard evenly, so its params load leaf
        # for leaf
        "embedding": embedding_init(generator, spec, device,
                                    pad_rows_to=512),
        "bot": mlp_init(generator, (cfg.n_dense,) + cfg.bot_mlp, device),
        "top": mlp_init(generator, (cfg.bot_mlp[-1] + n_pairs,)
                        + cfg.top_mlp, device),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _embed(params, cfg: RecsysConfig, sparse_ids: torch.Tensor
           ) -> torch.Tensor:
    emb = embedding_lookup(params["embedding"], cfg.embedding_spec(),
                           sparse_ids)
    return emb.to(cfg.compute_dtype)


def _batch_emb(params, cfg: RecsysConfig, batch: dict) -> torch.Tensor:
    """[B, F, dim] field embeddings for ``batch``, precomputed or looked
    up.  A batch carrying ``"emb"`` bypasses the substrate lookup (the
    serving tier's hot-row cache feeds rows this way)."""
    emb = batch.get("emb")
    if emb is not None:
        return emb.to(cfg.compute_dtype)
    return _embed(params, cfg, batch["sparse"])


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
            serve: bool = False) -> torch.Tensor:
    """batch: {"dense": [B,n_dense], "sparse": [B,F]} -> logits [B].

    ``serve`` marks the inference path, where the fused serve kernel may
    engage.  A batch may carry precomputed ``"emb"`` [B, F, dim]; it takes
    precedence over the substrate lookup and the fused kernel.
    """
    _check_arch(cfg)
    dense = batch["dense"].to(cfg.compute_dtype)
    bot = mlp_apply(params["bot"], dense, final_act=torch.relu)
    inter = _dlrm_interaction(params, cfg, batch, bot, serve)
    top_in = torch.cat([bot, inter], dim=-1)
    return mlp_apply(params["top"], top_in)[:, 0]


def serve_scores(params, cfg: RecsysConfig, batch: dict) -> torch.Tensor:
    """Online/bulk inference: CTR logits [B]."""
    return forward(params, cfg, batch, serve=True)


def loss_fn(params, cfg: RecsysConfig, batch: dict) -> Tuple[torch.Tensor,
                                                             dict]:
    """Mean binary cross-entropy of the logits against ``batch["label"]``,
    in the JAX package's form ``max(l, 0) - l·y + log1p(exp(-|l|))``.
    Returns (loss, {"logloss": loss})."""
    _check_arch(cfg)
    logits = forward(params, cfg, batch)
    y = batch["label"].to(torch.float32)
    ce = torch.mean(torch.clamp_min(logits, 0) - logits * y
                    + torch.log1p(torch.exp(-torch.abs(logits))))
    return ce, {"logloss": ce}


def make_project_fn(cfg: RecsysConfig):
    """Post-optimizer projection for the model's params, or None.

    Backends whose stored parameters are not what the math sees expose
    ``EmbeddingBackend.project``; this lifts it from the embedding subtree
    to the full param dict for ``build_train_step(project=...)``.  Float
    substrates (robe, hashed, tt) return None and the train step skips the
    hook.
    """
    _check_arch(cfg)
    spec = cfg.embedding_spec()
    backend = get_backend(spec.kind)
    if backend.project is None:
        return None

    def project(params):
        return dict(params,
                    embedding=backend.project(params["embedding"], spec))
    return project
