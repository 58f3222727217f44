"""``full`` -- the uncompressed baseline (PyTorch port of
``repro.nn.embedding_backends.full``): one concatenated [total_rows, dim]
table with per-field row offsets, the paper's "Original (100GB)"
substrate.

A lookup gathers the table's rows at ``idx + offsets[field]``; its
gradient is autograd's scatter of the cotangent into a dense table-sized
gradient.  The JAX package has no Pallas kernel for it either (its lookup
is a ``jnp.take``), so the gather is PyTorch's.  ``cacheable_rows`` serves
the hot-row cache the exact rows the lookup gathers.

Row sharding over a mesh (``lookup_dist``, ``param_specs``, the ``"2d"``
placement) comes with the port of distribution (ROADMAP module item 6):
one card holds the whole table (52.3 GB at ``dlrm-rm2`` width).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as nnf

from repro_torch.nn.embedding_backends.base import (EmbeddingBackend,
                                                    register_backend)


def _not_ported(what: str):
    raise NotImplementedError(
        f"full {what} is not yet ported: it comes with the port of "
        f"distribution (ROADMAP module item 6)")


class FullTableBackend(EmbeddingBackend):
    name = "full"

    def init(self, generator, spec, device, pad_rows_to: int = 1) -> dict:
        rows = spec.total_rows
        rows = ((rows + pad_rows_to - 1) // pad_rows_to) * pad_rows_to
        scale = float(1.0 / np.sqrt(spec.dim))
        table = torch.empty((rows, spec.dim), dtype=torch.float32,
                            device=generator.device)
        return {"table": table.uniform_(-scale, scale,
                                        generator=generator).to(device)}

    def lookup(self, params, spec, idx, fields=None):
        fields = fields if fields is not None else tuple(range(spec.n_fields))
        off = torch.as_tensor(spec.offsets[list(fields)], device=idx.device)
        return nnf.embedding(idx + off, params["table"])

    def cacheable_rows(self, params, spec, field: int,
                       ids: np.ndarray) -> np.ndarray:
        """Hot-row-cache hook: the exact rows ``lookup`` gathers for ``ids``
        in ``field``, as host f32 bits.  Only these rows are gathered on
        the table's device and copied to the host."""
        table = params["table"]
        rows = torch.as_tensor(np.asarray(ids, np.int64)
                               + int(spec.offsets[field]),
                               device=table.device)
        with torch.no_grad():
            return table[rows].cpu().numpy()

    def lookup_dist(self, params, spec, idx, *, compute_dtype=None):
        _not_ported("lookup_dist (the row-sharded lookup)")

    def param_specs(self, spec, rules, mesh=None) -> dict:
        _not_ported("param_specs (the row-sharded layout)")

    def param_count(self, spec) -> int:
        return spec.total_rows * spec.dim

    def cost(self, spec, batch: int) -> dict:
        # one dim-row fetch per (example, field)
        return {"params": self.param_count(spec),
                "bytes_fetched": batch * spec.n_fields * spec.dim * 4,
                "flops": 0}


register_backend(FullTableBackend())
