"""The four assigned recsys architectures + the paper's CriteoTB DLRM
(PyTorch port of ``repro.configs.recsys_archs``).

Vocab layouts:
* CriteoTB (MLPerf, 40M row cap — the paper's 100 GB model): 26 fields,
  ≈204M rows.  Used by dlrm-rm2 (d=64) and dlrm-criteo-tb (d=128, the exact
  MLPerf model the paper compresses 1000×).
* Criteo-Kaggle (paper appendix 6.4 counts, 33.76M rows): used with 13
  log-bucketized dense fields (vocab 64 each) for the 39-field archs
  (autoint, xdeepfm) exactly as those papers preprocess Criteo.
* Two-tower: 4 user + 4 item fields at YouTube-retrieval scale (synthetic
  sizes, documented), embed 256 ⇒ tower input 4·256 = 1024 = the assigned
  tower MLP's first layer.

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

# Criteo-Kaggle counts, verbatim from the paper's appendix 6.4.
CRITEO_KAGGLE_VOCABS = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572)

# 39-field layout: 13 bucketized dense + 26 categorical (AutoInt/xDeepFM).
CRITEO_39 = tuple([64] * 13) + CRITEO_KAGGLE_VOCABS

TWO_TOWER_VOCABS = (100_000_000, 1_000_000, 100_000, 10_000,   # user side
                    10_000_000, 1_000_000, 100_000, 1_000)     # item side

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


# --- autoint [recsys] 39 fields embed 16, 3 attn layers 2H d_attn 32 ------
_bundle("autoint",
        full_kw=dict(arch="autoint", vocab_sizes=CRITEO_39, embed_dim=16,
                     attn_layers=3, attn_dim=32, attn_heads=2),
        smoke_kw=dict(arch="autoint", vocab_sizes=SMOKE_VOCABS, embed_dim=8,
                      attn_layers=2, attn_dim=8, attn_heads=2,
                      robe_size=4096, robe_block=8))

# --- dlrm-rm2 [recsys] 13 dense + 26 sparse embed 64, dot interaction -----
_bundle("dlrm-rm2",
        full_kw=dict(arch="dlrm", vocab_sizes=CRITEO_TB_VOCABS, embed_dim=64,
                     n_dense=13, bot_mlp=(512, 256, 64),
                     top_mlp=(512, 512, 256, 1)),
        smoke_kw=dict(arch="dlrm", vocab_sizes=SMOKE_VOCABS, embed_dim=8,
                      n_dense=13, bot_mlp=(32, 8), top_mlp=(16, 1),
                      robe_size=4096, robe_block=8))

# --- two-tower-retrieval embed 256, towers 1024-512-256, dot -------------
_bundle("two-tower-retrieval",
        full_kw=dict(arch="two_tower", vocab_sizes=TWO_TOWER_VOCABS,
                     embed_dim=256, tower_mlp=(1024, 512, 256),
                     n_user_fields=4),
        smoke_kw=dict(arch="two_tower", vocab_sizes=SMOKE_VOCABS,
                      embed_dim=8, tower_mlp=(32, 16), n_user_fields=3,
                      robe_size=4096, robe_block=8),
        notes="train = in-batch sampled softmax; retrieval_cand scores one "
              "query against 10^6 candidates via batched dot.")

# --- xdeepfm [recsys] 39 fields embed 10, CIN 200-200-200, DNN 400-400 ----
_bundle("xdeepfm",
        full_kw=dict(arch="xdeepfm", vocab_sizes=CRITEO_39, embed_dim=10,
                     cin_layers=(200, 200, 200), dnn=(400, 400)),
        smoke_kw=dict(arch="xdeepfm", vocab_sizes=SMOKE_VOCABS, embed_dim=8,
                      cin_layers=(16, 16), dnn=(32,), robe_size=4096,
                      robe_block=8))

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
