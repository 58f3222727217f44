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

Batches arrive padded to a fixed shape with ``n_valid`` leading real rows
(the router's ``stack_and_pad`` contract); the scorer returns only the real
rows.  ``robe`` and ``qrobe`` decline the hot-row cache, as in the JAX
package.  The JAX server fronts ``full`` and ``hashed`` with a
``HotRowCache``; this port builds no cache yet, so ``cache_capacity`` is
not read until the serving tier is ported (ROADMAP module item 4), with
model pushes and cache warming.  Scores are the same either way: by the
``cacheable_rows`` contract the cached rows are bit-identical to the ones
the lookup gathers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.recsys import RecsysConfig, init_params, serve_scores

__all__ = ["ServerConfig", "EmbeddingServer"]

DEFAULT_BACKENDS = ("full", "robe", "hashed", "tt")


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """One scoring model per substrate, shared architecture.

    ``robe_compression`` sizes the ROBE array (robe, qrobe) at
    1/compression of the full table's parameters (the paper's 1000× knob);
    ``cache_capacity`` rows per cacheable substrate (not read until the
    hot-row cache is ported, ROADMAP module item 4);
    ``use_kernel`` routes robe serving through the one-pass ``serve_fused``
    kernel.
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
    seed: int = 0

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


class EmbeddingServer:
    """All substrates resident; ``score(backend, batch, n_valid)`` routes.

    Each substrate gets its own parameters: ``params[name]`` when given
    (e.g. carried from the JAX package by ``convert.params_from_numpy``),
    else ``init_params`` from a generator seeded ``cfg.seed + i``.
    """

    def __init__(self, cfg: ServerConfig,
                 params: Optional[Dict[str, dict]] = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._cfgs: Dict[str, RecsysConfig] = {}
        self._params: Dict[str, dict] = {}
        for i, name in enumerate(cfg.backends):
            rc = cfg.recsys_cfg(name)
            self._cfgs[name] = rc
            if params is not None:
                self._params[name] = params[name]
            else:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(cfg.seed + i)
                self._params[name] = init_params(rc, gen, self.device)

    @property
    def backends(self) -> Tuple[str, ...]:
        return tuple(self.cfg.backends)

    def recsys_config(self, backend: str) -> RecsysConfig:
        return self._cfgs[backend]

    def params(self, backend: str) -> dict:
        return self._params[backend]

    # -- scoring -----------------------------------------------------------

    def score(self, backend: str, batch: Dict[str, np.ndarray],
              n_valid: Optional[int] = None) -> np.ndarray:
        """Route one padded batch to ``backend``; returns [n_valid] scores.

        ``batch``: ``{"dense": [B, n_dense], "sparse": [B, F]}`` as numpy
        arrays or tensors; they are moved to the server's device.
        """
        if backend not in self._cfgs:
            raise KeyError(f"backend {backend!r} not resident; serving: "
                           f"{sorted(self._cfgs)}")
        tb = {k: torch.as_tensor(batch[k]).to(self.device)
              for k in ("dense", "sparse")}
        with torch.inference_mode():
            out = serve_scores(self._params[backend], self._cfgs[backend],
                               tb)
        out = out.cpu().numpy()
        return out[:n_valid] if n_valid is not None else out

    def score_fn(self, backend: str):
        """A ``score_fn(batch, n_valid=...)`` closure for a router or replay
        harness, bound to one substrate."""

        def fn(batch, n_valid=None):
            return self.score(backend, batch, n_valid)

        fn.__name__ = f"score_{backend}"
        return fn

    # -- not yet ported ----------------------------------------------------

    def push(self, backend: str, step: Optional[int] = None, *,
             ckpt_dir: Optional[str] = None):
        raise NotImplementedError("EmbeddingServer.push is not yet ported")

    def warm_caches(self, id_batches: Sequence[np.ndarray]) -> None:
        raise NotImplementedError("EmbeddingServer.warm_caches is not yet "
                                  "ported")
