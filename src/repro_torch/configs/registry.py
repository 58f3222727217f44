"""Architecture registry: ``get_arch(id)`` -> ArchBundle (PyTorch port of
``repro.configs.registry``: the LM, GNN and recsys bundles).

Each bundle carries the full-scale config, a reduced smoke config (same
structure, tiny dims) and its shape cells.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, Tuple

ARCH_IDS = (
    # LM family
    "kimi-k2-1t-a32b", "qwen3-moe-30b-a3b", "minicpm3-4b", "qwen3-0.6b",
    "qwen1.5-32b",
    # GNN
    "gatedgcn",
    # RecSys
    "autoint", "dlrm-rm2", "two-tower-retrieval", "xdeepfm",
    # the paper's own model (not an assigned cell; used by benchmarks)
    "dlrm-criteo-tb",
)

LM_SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1,
                      skip="pure full-attention arch (DESIGN.md §5): "
                           "sub-quadratic attention required at 512k"),
}

GNN_SHAPES = {
    "full_graph_sm": dict(kind="train", n_nodes=2708, n_edges=10556,
                          d_feat=1433),
    "minibatch_lg": dict(kind="train_sampled", n_nodes=232965,
                         n_edges=114615892, batch_nodes=1024,
                         fanouts=(15, 10), d_feat=602),
    "ogb_products": dict(kind="train", n_nodes=2449029, n_edges=61859140,
                         d_feat=100),
    "molecule": dict(kind="train", n_nodes=30, n_edges=64, batch=128),
}

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}


@dataclasses.dataclass(frozen=True)
class ArchBundle:
    arch_id: str
    kind: str                                    # "lm" | "gnn" | "recsys"
    shapes: Dict[str, dict]
    make_config: Callable[..., Any]              # (variant="full"|"smoke", **kw)
    notes: str = ""


_REGISTRY: Dict[str, ArchBundle] = {}


def register(bundle: ArchBundle) -> ArchBundle:
    _REGISTRY[bundle.arch_id] = bundle
    return bundle


def get_arch(arch_id: str) -> ArchBundle:
    if arch_id not in _REGISTRY:      # a bundle module imported alone
        _load_all()                   # registers only its own bundles
    return _REGISTRY[arch_id]


def all_arch_ids() -> Tuple[str, ...]:
    return ARCH_IDS[:-1]          # the assigned ones (excl. paper's own)


_MODULES = [
    "repro_torch.configs.lm_archs",
    "repro_torch.configs.gnn_archs",
    "repro_torch.configs.recsys_archs",
]


def _load_all() -> None:
    for m in _MODULES:
        importlib.import_module(m)
