#!/usr/bin/env python3
"""How far two quickstart training runs drift apart when only the order of
the ROBE scatter-add's sum changes.

    PYTHONPATH=src python3 tools/order_noise.py [--seeds 1 2 ...] [--steps N]

Trains the config of ``examples/quickstart.py`` (4 fields, dim 16, 100x
ROBE, batch 1024, adagrad lr 0.08) on the CPU from the port's own seed-0
init, once with the plain scatter (``index_add_`` in element order) and
once per seed with the elements fed to ``index_add_`` in a random order
each step: a stand-in for the card's atomics, which land in no fixed
order.  Prints, per seed, the largest per-step loss difference from the
element-order run, the first step that differs by more than 1e-5, and the
held-out AUC difference (steps 5000-5007).  CPU only; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.robe import robe_signs, robe_slots  # noqa: E402
from repro_torch.data import CtrDataConfig, CtrStream  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.recsys import (RecsysConfig, forward,  # noqa: E402
                                       init_params, loss_fn)
from repro_torch.train.metrics import auc  # noqa: E402
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         make_optimizer)
from repro_torch.train.train_loop import (TrainConfig,  # noqa: E402
                                          build_train_step, init_state, run)

VOCABS = (40_000, 10_000, 60_000, 5_000)


def permuted_scatter(seed: int):
    """``robe_lookup_bwd_ref`` with the elements summed in a random order
    (a new permutation each call)."""
    rs = np.random.RandomState(seed)

    def bwd(g, rows, table_ids, dim, spec):
        tids = torch.as_tensor(table_ids, dtype=torch.int64)[None, :]
        slots = robe_slots(spec, tids, rows, dim).reshape(-1)
        g32 = g.to(torch.float32)
        if spec.use_sign:
            g32 = g32 * robe_signs(spec, tids, rows, dim)
        perm = torch.from_numpy(rs.permutation(slots.numel()))
        gm = torch.zeros(spec.size, dtype=torch.float32)
        return gm.index_add_(0, slots[perm],
                             g32.reshape(-1)[perm]).to(g.dtype)
    return bwd


def train(cfg, params, stream, steps: int, bwd) -> tuple:
    """(losses, held-out AUC) of ``steps`` adagrad steps with ``bwd`` as the
    CPU scatter."""
    ops.robe_lookup_bwd_ref = bwd
    opt = make_optimizer(OptimizerConfig(kind="adagrad", lr=0.08))
    tc = TrainConfig()
    rep = run(init_state(params, opt, tc), build_train_step(
        lambda p, b: loss_fn(p, cfg, b), opt, tc), stream.batch_at, steps,
        tc)
    scores, labels = [], []
    with torch.no_grad():
        for s in range(5000, 5008):
            b = {k: torch.from_numpy(v) for k, v in stream.batch_at(s).items()}
            scores.append(forward(rep.state["params"], cfg, b).numpy())
            labels.append(b["label"].numpy())
    return np.asarray(rep.losses), auc(np.concatenate(labels),
                                       np.concatenate(scores))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(1, 11)))
    ap.add_argument("--steps", type=int, default=400)
    args = ap.parse_args()
    cfg = RecsysConfig(name="quickstart", arch="dlrm", n_dense=4,
                       bot_mlp=(32, 16), top_mlp=(32, 1), embed_dim=16,
                       vocab_sizes=VOCABS, embedding="robe",
                       robe_size=sum(VOCABS) * 16 // 100, robe_block=32)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = init_params(cfg, gen, "cpu")
    stream = CtrStream(CtrDataConfig(vocab_sizes=VOCABS, n_dense=4,
                                     batch_size=1024))
    base, base_auc = train(cfg, params, stream, args.steps,
                           ref.robe_lookup_bwd_ref)
    print(f"element order: loss {base[0]:.6f} -> {base[-1]:.6f}, "
          f"AUC {base_auc:.6f}")
    for seed in args.seeds:
        losses, a = train(cfg, params, stream, args.steps,
                          permuted_scatter(seed))
        d = np.abs(losses - base)
        first = int(np.argmax(d > 1e-5)) if (d > 1e-5).any() else None
        print(f"seed {seed}: max |loss diff| {d.max():.3e} at step "
              f"{int(d.argmax())}; first step > 1e-5: {first}; AUC diff "
              f"{a - base_auc:+.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
