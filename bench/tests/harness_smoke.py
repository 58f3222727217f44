"""Smoke-sized variants of the benchmark's cells, for the CPU tests: the
program's registry smoke shapes of ``dlrm-criteo-tb`` and ``xdeepfm``
(their numbers copied), small traffic, the cells' own files otherwise."""

from __future__ import annotations

import copy

SMOKE_VOCABS = [1000, 500, 2000, 100, 50, 300]

DLRM = {"vocab_sizes": SMOKE_VOCABS, "embed_dim": 16, "n_dense": 13,
        "bot_mlp": [64, 16], "top_mlp": [32, 1], "robe_compression": 8,
        "robe_size": 7900, "robe_block": 16}
XDEEPFM = {"vocab_sizes": SMOKE_VOCABS, "embed_dim": 8, "cin_layers": [16, 16],
           "dnn": [32], "robe_compression": 12, "robe_size": 4096,
           "robe_block": 8}
TRAFFIC = {"score-256k": {"batch": 512, "pool": 2, "check_units": 2,
                          "trace_seconds": 0.3},
           "score-64k": {"batch": 256, "pool": 2, "check_units": 2,
                         "trace_seconds": 0.3},
           "train-64k": {"batch": 256, "pool": 4, "trace_seconds": 0.3},
           "rank-2k-16k": {"requests": 8, "min_candidates": 16,
                           "max_candidates": 128, "check_requests": 4,
                           "trace_seconds": 0.3}}
#: limits of the smoke rehearsal that differ from the cell's: at this size
#: the program and the reference order their sums differently on the CPU,
#: so the median leaf's gradient gap reads some float32 noises (0.4-11 over
#: 40 seeds), where the card's kernels read under 0.2 of one
CHECKS = {"train-64k": {"grad_median_vs_f32": 100.0}}


def smoke(cell):
    """A copy of ``cell`` (``run.load_cell``) at smoke size."""
    cell = copy.deepcopy(cell)
    cell.cfg.update(DLRM if cell.cfg["arch"] == "dlrm" else XDEEPFM)
    cell.traffic.update(TRAFFIC[cell.wl["traffic"]])
    cell.wl["checks"].update(CHECKS.get(cell.wl["traffic"], {}))
    return cell
