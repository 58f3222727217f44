"""Entry ``serve_scores``: ``repro_torch.models.recsys.serve_scores`` under
``torch.inference_mode()``, as ``EmbeddingServer.score`` calls it (the
server builds only DLRMs): the batch copied from the host to the card,
scored, and the scores copied back.
"""

from __future__ import annotations

import numpy as np
import torch


def recsys_config(cfg: dict, use_kernel: bool = False):
    from repro_torch.models.recsys import RecsysConfig
    kw = dict(name=cfg["name"], arch=cfg["arch"],
              vocab_sizes=tuple(cfg["vocab_sizes"]),
              embed_dim=cfg["embed_dim"], embedding=cfg["embedding"],
              robe_size=cfg["robe_size"], robe_block=cfg["robe_block"],
              use_kernel=use_kernel)
    for key in ("n_dense", "bot_mlp", "top_mlp", "dnn", "cin_layers"):
        if key in cfg:
            v = cfg[key]
            kw[key] = tuple(v) if isinstance(v, list) else v
    return RecsysConfig(**kw)


class Entry:
    def __init__(self, cfg: dict, params: dict, device, options: dict):
        self.cfg = recsys_config(cfg, bool(options.get("use_kernel", False)))
        self.params = params
        self.device = device

    def score(self, batch: dict) -> np.ndarray:
        from repro_torch.models.recsys import serve_scores
        tb = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()
              if k in ("dense", "sparse")}
        with torch.inference_mode():
            out = serve_scores(self.params, self.cfg, tb)
        return out.cpu().numpy()
