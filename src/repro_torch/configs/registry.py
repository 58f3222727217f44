"""Architecture registry: ``get_arch(id)`` -> ArchBundle (PyTorch port of
``repro.configs.registry``; the recsys bundles: the LM and GNN ones wait
for the port of those families).

Each bundle carries the full-scale config, a reduced smoke config (same
structure, tiny dims) and its shape cells.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, Tuple

ARCH_IDS = (
    # RecSys
    "autoint", "dlrm-rm2", "two-tower-retrieval", "xdeepfm",
    # the paper's own model (not an assigned cell; used by benchmarks)
    "dlrm-criteo-tb",
)

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}


@dataclasses.dataclass(frozen=True)
class ArchBundle:
    arch_id: str
    kind: str                                    # "recsys"
    shapes: Dict[str, dict]
    make_config: Callable[..., Any]              # (variant="full"|"smoke", **kw)
    notes: str = ""


_REGISTRY: Dict[str, ArchBundle] = {}


def register(bundle: ArchBundle) -> ArchBundle:
    _REGISTRY[bundle.arch_id] = bundle
    return bundle


def get_arch(arch_id: str) -> ArchBundle:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[arch_id]


def all_arch_ids() -> Tuple[str, ...]:
    return ARCH_IDS[:-1]          # the assigned ones (excl. paper's own)


_MODULES = ["repro_torch.configs.recsys_archs"]


def _load_all() -> None:
    for m in _MODULES:
        importlib.import_module(m)
