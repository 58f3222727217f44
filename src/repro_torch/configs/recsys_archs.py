"""The paper's DLRM bundles (PyTorch port of ``repro.configs.
recsys_archs``; ``dlrm-rm2`` and ``dlrm-criteo-tb`` only, so far).

* CriteoTB (MLPerf, 40M row cap — the paper's 100 GB model): 26 fields,
  ≈204M rows.  Used by dlrm-rm2 (d=64) and dlrm-criteo-tb (d=128, the exact
  MLPerf model the paper compresses 1000×).

ROBE sizing follows the paper: 1000× compression of the full table bytes.
"""

from __future__ import annotations

from repro_torch.configs.registry import ArchBundle, RECSYS_SHAPES, register
from repro_torch.models.recsys import RecsysConfig

# MLPerf CriteoTB per-field rows (40M cap) — sums to ~204M (×128 ≈ 100GB).
CRITEO_TB_VOCABS = (
    40_000_000, 39_060, 17_295, 7_424, 20_265, 3, 7_122, 1_543, 63,
    40_000_000, 3_067_956, 405_282, 10, 2_209, 11_938, 155, 4, 976, 14,
    40_000_000, 40_000_000, 40_000_000, 590_152, 12_973, 108, 36)

SMOKE_VOCABS = (1000, 500, 2000, 100, 50, 300)


def _robe_slots(vocabs, dim, compression=1000):
    return max(4096, int(sum(vocabs)) * dim // compression)


def _bundle(arch_id, full_kw, smoke_kw, shapes=RECSYS_SHAPES, notes=""):
    def make_config(variant: str = "full", embedding: str = "robe",
                    robe_compression: int = 1000, **over):
        kw = dict(full_kw if variant == "full" else smoke_kw)
        kw.update(over)
        kw.setdefault("name", f"{arch_id}-{variant}")
        kw["embedding"] = embedding
        kw.setdefault("robe_size",
                      _robe_slots(kw["vocab_sizes"], kw["embed_dim"],
                                  robe_compression))
        kw.setdefault("robe_block", 32)
        return RecsysConfig(**kw)

    return register(ArchBundle(arch_id=arch_id, kind="recsys", shapes=shapes,
                               make_config=make_config, notes=notes))


# --- dlrm-rm2 [recsys] 13 dense + 26 sparse embed 64, dot interaction -----
_bundle("dlrm-rm2",
        full_kw=dict(arch="dlrm", vocab_sizes=CRITEO_TB_VOCABS, embed_dim=64,
                     n_dense=13, bot_mlp=(512, 256, 64),
                     top_mlp=(512, 512, 256, 1)),
        smoke_kw=dict(arch="dlrm", vocab_sizes=SMOKE_VOCABS, embed_dim=8,
                      n_dense=13, bot_mlp=(32, 8), top_mlp=(16, 1),
                      robe_size=4096, robe_block=8))

# --- the paper's model: MLPerf CriteoTB DLRM (100 GB -> 100 MB ROBE) ------
_bundle("dlrm-criteo-tb",
        full_kw=dict(arch="dlrm", vocab_sizes=CRITEO_TB_VOCABS,
                     embed_dim=128, n_dense=13, bot_mlp=(512, 256, 128),
                     top_mlp=(1024, 1024, 512, 256, 1)),
        smoke_kw=dict(arch="dlrm", vocab_sizes=SMOKE_VOCABS, embed_dim=16,
                      n_dense=13, bot_mlp=(64, 16), top_mlp=(32, 1),
                      robe_size=8192, robe_block=16),
        notes="paper §4.1: official MLPerf DLRM; target AUC 0.8025; "
              "ROBE 1000× ⇒ 26.1M slots ≈ 100MB.")
