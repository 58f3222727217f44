"""Entry ``server_score``: ``repro_torch.serve.server.EmbeddingServer.score``
on the ``robe`` substrate, the way a serving deployment calls it: numpy
batches on the host in, numpy scores out (the copies in and out are the
server's own).  ``options``: ``use_kernel`` (the fused ``serve_fused``
path) and ``cache_capacity``.
"""

from __future__ import annotations

import numpy as np


class Entry:
    def __init__(self, cfg: dict, params: dict, device, options: dict):
        from repro_torch.serve.server import EmbeddingServer, ServerConfig
        scfg = ServerConfig(
            vocab_sizes=tuple(cfg["vocab_sizes"]), embed_dim=cfg["embed_dim"],
            n_dense=cfg["n_dense"], bot_mlp=tuple(cfg["bot_mlp"]),
            top_mlp=tuple(cfg["top_mlp"]), backends=("robe",),
            robe_compression=cfg["robe_compression"],
            robe_block=cfg["robe_block"],
            use_kernel=bool(options.get("use_kernel", True)),
            cache_capacity=int(options.get("cache_capacity", 0)))
        if scfg.recsys_cfg("robe").robe_size != cfg["robe_size"]:
            raise ValueError("the server sizes the ROBE array otherwise "
                             "than the configuration states")
        self.server = EmbeddingServer(scfg, params={"robe": params},
                                      device=device)

    def score(self, batch: dict) -> np.ndarray:
        return self.server.score("robe", batch)
