"""What the cells read through ``archs/<arch>.py`` equals what they read
when each step was written out per architecture (commit b4be26c): the
weights from the seed, the model's FLOPs, the touched ROBE slots and the
reference's scores, byte for byte.  The values were recorded at that
commit, on the CPU at smoke size."""

from __future__ import annotations

import hashlib
import importlib

import pytest
import torch

import run
from harness_smoke import smoke
from lib import stream
from reference import models as ref

SCORE_CELLS = {"dlrm": "dlrm-tb-robe.score-256k",
               "xdeepfm": "xdeepfm-robe.score-64k"}
PARAMS = {
    ("dlrm", 1):
        "31be9e815726135ea40ec4741dce24c29a379d1cb20a80ff42c651e7ededde69",
    ("dlrm", 2 ** 31 + 5):
        "98dff50e856194bc82a9de6deb2c88214be6e1f2610fe539a57b2e597d1f1e4a",
    ("xdeepfm", 1):
        "432acb0b1e7c718710614389af9cf72e6b28706fbe1c6c02bb877a8d028b2b29",
    ("xdeepfm", 2 ** 31 + 5):
        "7664847e8821618a5ded9dc0c80587cc7206e26c740dad5782919fd52c9e4ed8",
}
#: the reference's logits of a batch of 300 of the stream, seed 99, step 0,
#: on the weights of seed 99
SCORES = {
    "dlrm": "0d345ed8fca438008c84d14258b7a3465378d61b5502b23ccbeecb12f12fd07d",
    "xdeepfm":
        "a072d13118e165530a97ca3a31f336c8463432bfc68c449c753f9a0dabd8a287",
}
FLOPS = {"dlrm-criteo-tb.robe": {"score": 4_820_224, "train": 14_454_272},
         "xdeepfm.robe": {"score": 69_295_990}}
#: slots of the first pool unit of each smoke cell, seed 2^31 + 977
TOUCHED = {"dlrm-tb-robe.score-256k": 7382, "xdeepfm-robe.score-64k": 3409,
           "dlrm-tb-robe.train-64k": 6545, "dlrm-tb-robe.rank-2k-16k": 3263}


def _sha_tree(tree) -> str:
    h = hashlib.sha256()
    for name, x in zip(ref.leaf_names(tree), ref.flatten(tree)[0]):
        h.update(name.encode())
        h.update(str(tuple(x.shape)).encode())
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _cfg(arch: str) -> dict:
    return smoke(run.load_cell(SCORE_CELLS[arch])).cfg


@pytest.mark.parametrize("arch,seed", sorted(PARAMS))
def test_params(arch, seed):
    cfg = _cfg(arch)
    assert _sha_tree(run.arch_of(cfg).make_params(cfg, seed, "cpu")) == \
        PARAMS[arch, seed]


@pytest.mark.parametrize("name", sorted(FLOPS))
def test_model_flops(name):
    cfg = run._json(run.BENCH / "configs" / f"{name}.json")
    assert run.arch_of(cfg).model_flops(cfg) == FLOPS[name]


@pytest.mark.parametrize("workload", sorted(TOUCHED))
def test_touched(workload):
    cell = smoke(run.load_cell(workload))
    driver = importlib.import_module("traffic." + cell.traffic["driver"])
    pool = driver.inputs(cell.cfg, cell.traffic, 2 ** 31 + 977)
    assert run.arch_of(cell.cfg).touched(cell.cfg, pool[0], "cpu") == \
        TOUCHED[workload]


@pytest.mark.parametrize("arch", sorted(SCORES))
def test_reference_scores(arch):
    cfg = _cfg(arch)
    batch = stream.batch_at(cfg["vocab_sizes"], cfg.get("n_dense", 0), 300,
                            99, 0, labels=False)
    scores = run.Reference(cfg, 99, torch.device("cpu")).scores(batch)
    assert hashlib.sha256(scores.tobytes()).hexdigest() == SCORES[arch]
