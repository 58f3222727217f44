"""The frozen copies under bench/ against what they were copied from, and
the work counts against a hand count at a tiny size."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import run
from lib import stream, work
from reference.robe_hash import Robe


@pytest.mark.parametrize("seed", [0, 1234, 2 ** 31 + 7])
@pytest.mark.parametrize("n_dense", [0, 13])
def test_stream_is_the_programs(seed, n_dense):
    from repro_torch.data.synthetic_ctr import CtrDataConfig, CtrStream
    vocab = (1000, 3, 40_000_000, 64, 500)
    prog = CtrStream(CtrDataConfig(vocab_sizes=vocab, n_dense=n_dense,
                                   batch_size=300, seed=seed))
    for step in (0, 5):
        want = prog.batch_at(step)
        got = stream.batch_at(vocab, n_dense, 300, seed, step)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        nolab = stream.batch_at(vocab, n_dense, 300, seed, step,
                                labels=False)
        assert "label" not in nolab
        np.testing.assert_array_equal(nolab["sparse"], want["sparse"])


@pytest.mark.parametrize("block,dim,sign", [(32, 128, False), (32, 10, False),
                                            (8, 8, True), (16, 3, False)])
def test_robe_hash_is_the_programs(block, dim, sign):
    from repro_torch.core.robe import RobeSpec, robe_signs, robe_slots
    spec = RobeSpec(size=26_135_627 if dim == 128 else 9_973,
                    block_size=block, seed=11, use_sign=sign)
    mine = Robe(size=spec.size, block=block, seed=11, use_sign=sign)
    g = torch.Generator().manual_seed(3)
    rows = torch.randint(0, 40_000_000, (64, 5), generator=g,
                         dtype=torch.int32)
    rows[0] = 39_999_999
    tids = torch.arange(5)[None, :]
    assert torch.equal(mine.slots(tids, rows, dim),
                       robe_slots(spec, tids, rows, dim))
    assert torch.equal(mine.signs(tids, rows, dim),
                       robe_signs(spec, tids, rows, dim))
    mem = torch.randn(spec.size, generator=g)
    from repro_torch.kernels.ref import robe_lookup_ref
    assert torch.equal(mine.lookup(mem, rows, dim),
                       robe_lookup_ref(mem, rows, tuple(range(5)), dim,
                                       spec))


def test_touched_counts_distinct_slots():
    robe = Robe(size=1000, block=8, seed=5)
    rows = torch.tensor([[0, 1], [0, 1], [3, 2]], dtype=torch.int32)
    slots = robe.slots(torch.arange(2)[None, :], rows, 4)
    assert robe.touched(rows, 4, chunk=1) == len(set(slots.flatten()
                                                      .tolist()))


def test_kernel_counts_by_hand():
    # B=2, F=3, d=4, 10 touched slots
    assert work.robe_lookup(2, 3, 4, 10) == (2 * 3 * 4 + 40 + 2 * 3 * 4 * 4,
                                            0)
    # the triangle of 4 vectors has 6 pairs; 2·6·4 multiply-adds a sample
    assert work.serve_fused(2, 3, 4, 10) == (24 + 32 + 40 + 2 * 6 * 4,
                                            2 * 2 * 6 * 4 + 2 * 3 * 4)
    assert work.robe_lookup_bwd(2, 3, 4, 10) == (96 + 24 + 40, 0)
    assert work.dot_interaction_bwd(2, 4, 4) == (2 * 2 * 4 * 4 * 4
                                                 + 2 * 6 * 4,
                                                 2 * 2 * 16 * 4)
    assert work.bound_s(3.35e12, 0, (3.35e12, 67e12)) == 1.0
    assert work.bound_s(0, 134e12, (3.35e12, 67e12)) == 2.0


def test_model_flops_by_hand():
    cfg = {"arch": "dlrm", "vocab_sizes": [5, 5], "embed_dim": 2,
           "n_dense": 3, "bot_mlp": [4, 2], "top_mlp": [3, 1]}
    # bot 3-4-2, 3 features -> 3 pairs, top (2+3)-3-1
    fwd = 2 * (3 * 4 + 4 * 2) + 2 * (5 * 3 + 3 * 1) + 2 * 3 * 2
    bwd = 2 * (2 * (3 * 4 + 4 * 2) + 2 * (5 * 3 + 3 * 1)) - 2 * 3 * 4 \
        + 2 * 9 * 2
    assert work.dlrm_flops(cfg) == {"score": fwd, "train": fwd + bwd}
    x = {"arch": "xdeepfm", "vocab_sizes": [5, 5, 5], "embed_dim": 2,
         "cin_layers": [4, 4], "dnn": [3]}
    cin = (3 * 3 * 2 + 2 * 4 * 3 * 3 * 2 + 4 * 2) \
        + (3 * 4 * 2 + 2 * 4 * 3 * 4 * 2 + 4 * 2)
    want = cin + 2 * 8 + 2 * (6 * 3 + 3 * 1) + 2 * 6
    assert work.xdeepfm_flops(x) == {"score": want}


def test_published_flops():
    dlrm = run._json(run.BENCH / "configs" / "dlrm-criteo-tb.robe.json")
    xdf = run._json(run.BENCH / "configs" / "xdeepfm.robe.json")
    assert work.dlrm_flops(dlrm) == {"score": 4_820_224,
                                     "train": 14_454_272}
    assert 69e6 < work.xdeepfm_flops(xdf)["score"] < 69.5e6


def test_configs_are_the_programs():
    """The configuration files hold the program's published bundles."""
    from repro_torch.configs.registry import get_arch
    for name, arch in (("dlrm-criteo-tb.robe", "dlrm-criteo-tb"),
                       ("xdeepfm.robe", "xdeepfm")):
        cfg = json.loads((run.BENCH / "configs" / f"{name}.json")
                         .read_text())
        rc = get_arch(arch).make_config("full", embedding="robe")
        assert tuple(cfg["vocab_sizes"]) == rc.vocab_sizes
        assert cfg["embed_dim"] == rc.embed_dim
        assert cfg["robe_size"] == rc.robe_size
        assert cfg["robe_block"] == rc.robe_block
        spec = rc.embedding_spec().robe
        assert (cfg["robe_seed"], cfg["robe_use_sign"]) == (spec.seed,
                                                            spec.use_sign)
        for key in ("n_dense", "bot_mlp", "top_mlp", "dnn", "cin_layers"):
            if key in cfg:
                v = cfg[key]
                assert (tuple(v) if isinstance(v, list) else v) == \
                    getattr(rc, key)
