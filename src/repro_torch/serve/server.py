"""Embedding server (PyTorch port of ``repro.serve.server``; the ``full``,
``robe``, ``qrobe``, ``hashed`` and ``tt`` substrates).

One ``EmbeddingServer`` holds a DLRM scoring model per resident substrate
and routes each request to it through ``serve_scores``.  For ``robe`` with
``use_kernel`` that is the fused ``serve_fused`` kernel, else the unfused
``robe_lookup`` -> concat -> ``dot_interaction`` kernels.  ``full``,
``qrobe``, ``hashed`` and ``tt`` decline the fused path and always take the
unfused one, with their own lookups (``full``'s row gather, ``qrobe_lookup``,
which adds its ``delta`` term in the same launch, ``qr_lookup``,
``tt_lookup``).  On the card every path runs the Hopper kernels; on the CPU
(``device="cpu"``) the plain versions.

The fetch-bound substrates (``full``/``hashed``) are fronted by a
``HotRowCache`` when ``cache_capacity`` > 0: the server gathers their rows
through the cache on the host (bit-exact by the ``cacheable_rows``
contract; the misses are gathered on the server's device) and feeds the
scorer the batch's embeddings through its ``"emb"`` key, so switching the
cache on can never change a score.  ``robe``, ``qrobe`` and ``tt``
decline the cache, as in the JAX package.

Batches arrive padded to a fixed shape with ``n_valid`` leading real rows
(the router's ``stack_and_pad`` contract); the scorer returns only the real
rows, and the cache never counts the padded tail.

``push`` hot-swaps a substrate's parameters to a publish of an
``OnlineTrainer`` (``train/checkpoint.py``'s ``restore_delta``) and
reconciles the cache with the publish's touched-row manifest.

Under an active ``repro_torch.dist`` context the server holds each
substrate's shards by its spec tree (``dist.param_specs.recsys_specs``,
pruned to the mesh; ``EmbeddingServer``'s ``placement`` chooses the
ZeRO-3 array and the 2d table), and every rank calls ``score`` with
the same global batch: the scorers pick up the mesh through each
backend's own ``lookup_dist`` / ``fused_serve`` and return the global
scores.  A row-sharded table declines the hot-row cache (its rows are
not on one rank).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist import api as dist
from repro_torch.dist.param_specs import recsys_specs
from repro_torch.models.recsys import RecsysConfig, init_params, serve_scores
from repro_torch.nn.embeddings import get_backend
from repro_torch.serve.hot_cache import HotRowCache
from repro_torch.train import checkpoint as ckpt_lib

__all__ = ["ServerConfig", "EmbeddingServer", "PushReport"]

DEFAULT_BACKENDS = ("full", "robe", "hashed", "tt")


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """One scoring model per substrate, shared architecture.

    ``robe_compression`` sizes the ROBE array (robe, qrobe) at
    1/compression of the full table's parameters (the paper's 1000× knob);
    ``cache_capacity`` rows per cacheable substrate (0 disables the hot
    cache); ``use_kernel`` routes robe serving through the one-pass
    ``serve_fused`` kernel.
    """

    vocab_sizes: Tuple[int, ...]
    embed_dim: int = 16
    n_dense: int = 8
    bot_mlp: Tuple[int, ...] = ()        # () -> (64, embed_dim)
    top_mlp: Tuple[int, ...] = (64, 1)
    backends: Tuple[str, ...] = DEFAULT_BACKENDS
    robe_compression: int = 1000
    robe_block: int = 32
    use_kernel: bool = False
    cache_capacity: int = 16384
    cache_admit_threshold: int = 1
    sketch_width: int = 1 << 16
    seed: int = 0
    #: default publish dir ``push()`` restores from (an ``OnlineTrainer``'s
    #: ``publish_dir``); per-call ``ckpt_dir`` overrides
    model_dir: Optional[str] = None

    def recsys_cfg(self, backend: str) -> RecsysConfig:
        bot = self.bot_mlp or (64, self.embed_dim)
        n_emb = sum(self.vocab_sizes) * self.embed_dim
        return RecsysConfig(
            name=f"serve-{backend}", arch="dlrm",
            vocab_sizes=self.vocab_sizes, embed_dim=self.embed_dim,
            n_dense=self.n_dense, bot_mlp=bot, top_mlp=self.top_mlp,
            embedding=backend,
            robe_size=max(512, n_emb // self.robe_compression),
            robe_block=self.robe_block, use_kernel=self.use_kernel)


@dataclasses.dataclass(frozen=True)
class PushReport:
    """What one ``EmbeddingServer.push`` did."""

    backend: str
    step: int
    kind: str                 # "full" | "delta"
    invalidated: int          # cache rows dropped by the touched manifest
    cache_cleared: bool       # full push (or unanchored delta) → drop all
    wall_s: float


def _placed_cfg(rc: RecsysConfig, placement: Optional[str]) -> RecsysConfig:
    if placement is None:
        return rc
    if rc.embedding == "robe" and placement == "model":
        return dataclasses.replace(rc, robe_shard_model=True)
    if rc.embedding == "full" and placement in ("model", "2d"):
        return dataclasses.replace(rc, full_table_shard=placement)
    raise ValueError(f"no placement {placement!r} for {rc.embedding}")


def _host(x) -> np.ndarray:
    """A batch array as numpy (a tensor is copied to the host)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


class EmbeddingServer:
    """All substrates resident; ``score(backend, batch, n_valid)`` routes.

    Each substrate gets its own parameters: ``params[name]`` when given
    (e.g. carried from the JAX package by ``convert.params_from_numpy``),
    else ``init_params`` from a generator seeded ``cfg.seed + i``.  Under
    a mesh they are global trees, cut here to the rank's shards;
    ``placement`` maps a backend to its embedding placement there (robe
    ``"model"``: the ZeRO-3 array; full ``"model"`` (its default) or
    ``"2d"``).
    """

    def __init__(self, cfg: ServerConfig,
                 params: Optional[Dict[str, dict]] = None, device=None,
                 placement: Optional[Dict[str, str]] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._cfgs: Dict[str, RecsysConfig] = {}
        self._params: Dict[str, dict] = {}
        self._caches: Dict[str, Optional[HotRowCache]] = {}
        self._specs: Dict[str, object] = {}
        ctx = dist.current()
        for i, name in enumerate(cfg.backends):
            rc = _placed_cfg(cfg.recsys_cfg(name), (placement or {}).get(
                name))
            self._cfgs[name] = rc
            if params is not None:
                p = params[name]
            else:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(cfg.seed + i)
                p = init_params(rc, gen, self.device)
            if ctx is not None:
                specs = dist.prune_specs(
                    recsys_specs(p, ctx.rules, rc.embedding_spec(),
                                 mesh=ctx.mesh), p, ctx.mesh)
                self._specs[name] = specs
                p = dist.place(p, specs, ctx, device=self.device)
                if cfg.cache_capacity > 0 and get_backend(
                        name).cacheable_rows is not None and any(
                        len(s) and s[0] is not None
                        for s in specs["embedding"].values()):
                    raise ValueError(f"{name}: a row-sharded substrate "
                                     f"declines the hot-row cache; set "
                                     f"cache_capacity=0")
            self._params[name] = p
            cache = None
            if cfg.cache_capacity > 0:
                # the cache gathers through the embedding-layer subtree —
                # the same params the lookup sees
                cache = HotRowCache.for_backend(
                    get_backend(name), rc.embedding_spec(),
                    self._params[name]["embedding"],
                    capacity=cfg.cache_capacity,
                    sketch_width=cfg.sketch_width,
                    admit_threshold=cfg.cache_admit_threshold,
                    seed=cfg.seed)
            self._caches[name] = cache
        # last publish step applied per backend (None: still on init params)
        self._pushed_step: Dict[str, Optional[int]] = \
            {name: None for name in cfg.backends}

    @property
    def backends(self) -> Tuple[str, ...]:
        return tuple(self.cfg.backends)

    def pushed_step(self, backend: str) -> Optional[int]:
        """Step of the last publish applied (None before any push)."""
        return self._pushed_step[backend]

    def recsys_config(self, backend: str) -> RecsysConfig:
        return self._cfgs[backend]

    def params(self, backend: str) -> dict:
        return self._params[backend]

    def cache(self, backend: str) -> Optional[HotRowCache]:
        return self._caches[backend]

    # -- scoring -----------------------------------------------------------

    def score(self, backend: str, batch: Dict[str, np.ndarray],
              n_valid: Optional[int] = None, *,
              use_cache: bool = True) -> np.ndarray:
        """Route one padded batch to ``backend``; returns [n_valid] scores.

        ``batch``: ``{"dense": [B, n_dense], "sparse": [B, F]}`` as numpy
        arrays or tensors; they are moved to the server's device.  With a
        hot cache resident for this substrate (and ``use_cache``), the
        sparse gather happens through the cache on the host and the scorer
        receives the rows as ``"emb"`` — the scores are bit-identical
        either way (``cacheable_rows`` contract).
        """
        if backend not in self._cfgs:
            raise KeyError(f"backend {backend!r} not resident; serving: "
                           f"{sorted(self._cfgs)}")
        cache = self._caches[backend] if use_cache else None
        dense = torch.as_tensor(batch["dense"]).to(self.device)
        if cache is not None:
            emb = cache.lookup(_host(batch["sparse"]), n_valid)
            tb = {"dense": dense,
                  "emb": torch.from_numpy(emb).to(self.device)}
        else:
            tb = {"dense": dense,
                  "sparse": torch.as_tensor(batch["sparse"]).to(self.device)}
        with torch.inference_mode(), dist.placed(self._specs.get(backend)):
            out = serve_scores(self._params[backend], self._cfgs[backend],
                               tb)
        out = out.cpu().numpy()
        return out[:n_valid] if n_valid is not None else out

    def score_fn(self, backend: str, *, use_cache: bool = True):
        """A ``score_fn(batch, n_valid=...)`` closure for a router, a
        ``MicroBatcher`` or the replay harness, bound to one substrate."""

        def fn(batch, n_valid=None):
            return self.score(backend, batch, n_valid, use_cache=use_cache)

        fn.__name__ = f"score_{backend}"
        return fn

    # -- zero-downtime model push -------------------------------------------

    def push(self, backend: str, step: Optional[int] = None, *,
             ckpt_dir: Optional[str] = None) -> PushReport:
        """Hot-swap ``backend``'s params to a published checkpoint.

        Restores the publish at ``step`` (newest when None) from
        ``ckpt_dir`` (default ``cfg.model_dir``) via
        ``checkpoint.restore_delta``, onto the server's device, swaps the
        parameter tree in one assignment, and reconciles the hot cache:

        * delta publish whose chain anchors at this server's last applied
          step → ``invalidate`` exactly the union of touched rows for
          chain entries past that anchor (untouched entries survive,
          bit-exact by the delta contract);
        * full publish, first push, or an unanchored chain (the server
          skipped past a full base) → ``clear`` — nothing bounds what
          changed, so everything must refetch.

        The swap rebinds the backend's tree to the fresh tensors
        ``restore_delta`` builds and never writes into the old ones, which
        other servers (a fleet's replicas) may share.  It is atomic with
        respect to a dispatching ``AsyncRouter``/replay loop (scoring is
        synchronous between micro-batches; see ``AsyncRouter.apply``):
        in-flight batches complete on the old params, the next dispatched
        batch scores on the new ones, and no batch ever sees a mix.
        """
        t0 = time.perf_counter()
        ckpt_dir = ckpt_dir if ckpt_dir is not None else self.cfg.model_dir
        if ckpt_dir is None:
            raise ValueError("push: no ckpt_dir given and cfg.model_dir "
                             "is unset")
        shardings = None
        if backend in self._specs:
            shardings = dist.named_shardings(dist.current(),
                                             self._specs[backend])
        restored = ckpt_lib.restore_delta(ckpt_dir, self._params[backend],
                                          step=step, shardings=shardings)
        if restored is None:
            raise FileNotFoundError(
                f"push: no restorable publish in {ckpt_dir}"
                + (f" at step {step}" if step is not None else ""))
        new_params, manifest = restored
        new_step = int(manifest["step"])
        last = self._pushed_step[backend]

        invalidated, cleared = 0, False
        cache = self._caches[backend]
        if cache is not None:
            anchors = {int(manifest.get("base_full_step", new_step))}
            anchors.update(int(c["step"]) for c in manifest.get("chain", []))
            if manifest.get("delta") and last is not None and last in anchors:
                for c in manifest["chain"]:
                    if int(c["step"]) > last:
                        invalidated += cache.invalidate_manifest(c["touched"])
            else:
                cache.clear()
                cleared = True
            cache.set_params(new_params["embedding"])

        self._params[backend] = new_params
        self._pushed_step[backend] = new_step
        return PushReport(backend=backend, step=new_step,
                          kind="delta" if manifest.get("delta") else "full",
                          invalidated=invalidated, cache_cleared=cleared,
                          wall_s=time.perf_counter() - t0)

    # -- cache bookkeeping --------------------------------------------------

    def cache_stats(self, backend: str) -> Optional[dict]:
        cache = self._caches[backend]
        return None if cache is None else cache.stats()

    def warm_caches(self, id_batches: Sequence[np.ndarray]) -> None:
        """Pre-heat every resident cache from prior traffic ids."""
        for cache in self._caches.values():
            if cache is not None:
                cache.warm(id_batches)

    def reset_cache_stats(self) -> None:
        for cache in self._caches.values():
            if cache is not None:
                cache.reset_stats()

    def reset_caches(self) -> None:
        """Full cold-start reset of every resident cache — store, sketch
        heat, and counters (``HotRowCache.reset``).  The replay grid calls
        this between cells so no cell's traffic distribution leaks into
        the next one's resident set or admission heat."""
        for cache in self._caches.values():
            if cache is not None:
                cache.reset()
