"""The output check sees the faults a cell can have.  Each run skips the
look for a card and drives the rest of a run at smoke size on the CPU,
with the fault planted under the timed path (``lib/faults.py``), and the
check must come out false.  The TF32 control runs on the card only (the
CPU has no TF32), at the cell's own size, on three seeds."""

from __future__ import annotations

import json

import pytest
import torch

import run
from harness_smoke import smoke

FAULTS = {"dlrm-tb-robe.score-256k": ("half_batch", "alter"),
          "xdeepfm-robe.score-64k": ("half_batch", "alter"),
          "dlrm-tb-robe.train-64k": ("unchanged", "half_batch"),
          "dlrm-tb-robe.rank-2k-16k": ("half_batch", "alter")}
CASES = [(w, f) for w, fs in FAULTS.items() for f in fs]


def test_every_cell_has_its_faults():
    bm = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    assert {w["name"] for w in bm["workloads"]} == set(FAULTS)


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_fails_the_check(workload, fault):
    run._environment()
    cell = smoke(run.load_cell(workload))
    result = run.run_cell(cell, 2 ** 31 + 31, 0.2, False,
                          torch.device("cpu"), fault=fault)
    assert result["correct"] is False, result["checks"]


@pytest.mark.chip
@pytest.mark.parametrize("workload", list(FAULTS))
def test_tf32_control_fails_on_the_card(workload, card):
    cell = run.load_cell(workload)
    run._environment()
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        result = run.run_cell(cell, seed, 2.0, False, card, control="tf32")
        assert result["correct"] is False, result["checks"]
