"""``tt`` — tensor-train factorized embedding tables, the TT-Rec baseline
(PyTorch port of ``repro.nn.embedding_backends.tt``).

The concatenated logical [total_rows, dim] table is viewed as a 3-way
tensor [n1·n2·n3, d1·d2·d3] (n1·n2·n3 ≥ total_rows, d1·d2·d3 = dim) and
stored as three cores

    G1 [n1, d1, r]   G2 [n2, r, d2, r]   G3 [n3, r, d3]

Row ``g`` splits mixed-radix into (i1, i2, i3), i3 fastest; its embedding
is the chain G1[i1] · G2[i2] · G3[i3] reshaped to [dim], never
materialized.  The cores are replicated, so lookups are local.  A lookup
runs the ``tt_lookup`` op: on the card the Hopper kernel splits the index,
gathers the three slices and contracts the chain in one pass.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.dist.api import P
from repro_torch.kernels.ops import tt_lookup
from repro_torch.nn.embedding_backends.base import (EmbeddingBackend,
                                                    register_backend)


@functools.lru_cache(maxsize=128)
def factor_rows(n: int) -> Tuple[int, int, int]:
    """(n1, n2, n3) with n1·n2·n3 ≥ n, each ≈ n^(1/3)."""
    n3 = max(1, int(round(n ** (1.0 / 3.0))))
    n2 = max(1, int(round((n / n3) ** 0.5)))
    n1 = -(-n // (n2 * n3))
    return n1, n2, n3


@functools.lru_cache(maxsize=128)
def factor_dim(d: int) -> Tuple[int, int, int]:
    """(d1, d2, d3) exact factorization of d, as balanced as possible."""
    best, best_key = (d, 1, 1), d
    for d1 in range(1, d + 1):
        if d % d1:
            continue
        rest = d // d1
        for d2 in range(1, rest + 1):
            if rest % d2:
                continue
            d3 = rest // d2
            key = max(d1, d2, d3)
            if key < best_key:
                best, best_key = (d1, d2, d3), key
    return best


def _rank(spec) -> int:
    return int(spec.tt_rank) if spec.tt_rank > 0 else 8


def _dims(spec):
    return factor_rows(spec.total_rows), factor_dim(spec.dim), _rank(spec)


class TensorTrainBackend(EmbeddingBackend):
    name = "tt"

    def init(self, generator, spec, device, pad_rows_to: int = 1) -> dict:
        (n1, n2, n3), (d1, d2, d3), r = _dims(spec)
        # e sums r² products of three factors: std(e) ≈ r·σ³, so σ puts
        # rows at the full table's 1/√dim scale
        sigma = float((1.0 / (np.sqrt(spec.dim) * r)) ** (1.0 / 3.0))

        def normal(shape):
            w = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=generator.device) * sigma
            return w.to(device)

        return {"core0": normal((n1, d1, r)), "core1": normal((n2, r, d2, r)),
                "core2": normal((n3, r, d3))}

    def lookup(self, params, spec, idx, fields=None):
        fields = fields if fields is not None else tuple(range(spec.n_fields))
        factors, _, _ = _dims(spec)
        return tt_lookup(params["core0"], params["core1"], params["core2"],
                         idx, tuple(int(spec.offsets[f]) for f in fields),
                         factors, spec.dim)

    def param_specs(self, spec, rules, mesh=None) -> dict:
        # replicated on every mesh: a degraded mesh changes nothing, the
        # elastic restore re-broadcasts the cores to the survivors
        return {"core0": P(), "core1": P(), "core2": P()}

    def param_count(self, spec) -> int:
        (n1, n2, n3), (d1, d2, d3), r = _dims(spec)
        return n1 * d1 * r + n2 * r * d2 * r + n3 * r * d3

    def cost(self, spec, batch: int) -> dict:
        (n1, n2, n3), (d1, d2, d3), r = _dims(spec)
        per_row_bytes = (d1 * r + r * d2 * r + r * d3) * 4
        per_row_flops = 2 * (d1 * d2 * r * r + d1 * d2 * d3 * r)
        return {"params": self.param_count(spec),
                "bytes_fetched": batch * spec.n_fields * per_row_bytes,
                "flops": batch * spec.n_fields * per_row_flops}


register_backend(TensorTrainBackend())
