"""Entry ``train_step``: the ``step_fn`` of
``repro_torch.train.train_loop.build_train_step`` over
``models.recsys.loss_fn``, with the configuration's optimizer, on the
state of ``init_state``.  Each call copies a labelled host batch to the
card and issues one step; nothing waits for the card.
"""

from __future__ import annotations

import torch

from entries.serve_scores import recsys_config


class Entry:
    def __init__(self, cfg: dict, params: dict, device, options: dict):
        from repro_torch.models.recsys import loss_fn
        from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
        from repro_torch.train.train_loop import (TrainConfig,
                                                  build_train_step,
                                                  init_state)
        rc = recsys_config(cfg)
        opt = make_optimizer(OptimizerConfig(**cfg["optimizer"]))
        tc = TrainConfig()
        self.step_fn = build_train_step(lambda p, b: loss_fn(p, rc, b), opt,
                                        tc)
        self.state = init_state(params, opt, tc)
        self.device = device

    def step(self, batch: dict) -> dict:
        tb = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        self.state, metrics = self.step_fn(self.state, tb)
        return metrics

    def params(self) -> dict:
        return self.state["params"]
