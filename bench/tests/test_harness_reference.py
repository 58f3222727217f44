"""The plain reference against the program at smoke size on the CPU:
logits of both configurations, and the DLRM's loss and every gradient
leaf, from the same weights and batch."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import run
from entries.serve_scores import recsys_config
from harness_smoke import smoke
from lib import stream
from lib.params import make_params
from reference import models as ref


def _cfg(workload: str) -> dict:
    return smoke(run.load_cell(workload)).cfg


@pytest.mark.parametrize("workload", ["dlrm-tb-robe.score-256k",
                                      "xdeepfm-robe.score-64k"])
def test_reference_logits_match_program(workload):
    from repro_torch.models.recsys import serve_scores
    cfg = _cfg(workload)
    params = make_params(cfg, 99, "cpu")
    batch = stream.batch_at(cfg["vocab_sizes"], cfg.get("n_dense", 0), 300,
                            99, 0, labels=False)
    want = ref.scores(params, cfg, batch, "cpu")
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.inference_mode():
        got = serve_scores(params, recsys_config(cfg), tb).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_reference_loss_and_grads_match_program():
    from repro_torch.models.recsys import loss_fn
    cfg = _cfg("dlrm-tb-robe.train-64k")
    params = make_params(cfg, 5, "cpu")
    batch = stream.batch_at(cfg["vocab_sizes"], cfg["n_dense"], 256, 5, 1)
    loss, grads = ref.loss_and_grad(params, cfg, batch, "cpu")
    leaves, unflat = ref.flatten(params)
    xs = [p.clone().requires_grad_(True) for p in leaves]
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    pl = loss_fn(unflat(xs), recsys_config(cfg), tb)[0]
    gs = torch.autograd.grad(pl, xs)
    assert abs(float(pl.detach()) - loss) < 1e-6 * abs(loss)
    for g, r, name in zip(gs, ref.flatten(grads)[0], ref.leaf_names(params)):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-7, msg=name)


def test_params_are_the_programs_tree():
    """The benchmark's weights have the shapes of the program's own init."""
    from repro_torch.models.recsys import init_params
    for workload in ("dlrm-tb-robe.score-256k", "xdeepfm-robe.score-64k"):
        cfg = _cfg(workload)
        mine = make_params(cfg, 1, "cpu")
        theirs = init_params(recsys_config(cfg), torch.Generator(), "cpu")
        assert ref.leaf_names(mine) == ref.leaf_names(theirs)
        for a, b in zip(ref.flatten(mine)[0], ref.flatten(theirs)[0]):
            assert a.shape == b.shape and a.dtype == b.dtype


def test_params_repeat_for_a_seed():
    cfg = _cfg("dlrm-tb-robe.score-256k")
    a, b = make_params(cfg, 2 ** 31 + 5, "cpu"), make_params(cfg, 2 ** 31 + 5,
                                                             "cpu")
    c = make_params(cfg, 2 ** 31 + 6, "cpu")
    la, lb, lc = (ref.flatten(t)[0] for t in (a, b, c))
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert not torch.equal(la[0], lc[0])
