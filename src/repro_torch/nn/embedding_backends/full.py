"""``full`` -- the uncompressed baseline (PyTorch port of
``repro.nn.embedding_backends.full``): one concatenated [total_rows, dim]
table with per-field row offsets, the paper's "Original (100GB)"
substrate.

A lookup gathers the table's rows at ``idx + offsets[field]``; its
gradient is autograd's scatter of the cotangent into a dense table-sized
gradient.  The JAX package has no Pallas kernel for it either (its lookup
is a ``jnp.take``), so the gather is PyTorch's.  ``cacheable_rows`` serves
the hot-row cache the exact rows the lookup gathers.

Placement (``spec.placement``) under a ``repro_torch.dist`` context:

* ``"default"`` / ``"model"`` -- rows sharded over the ``model`` axis.
  The distributed lookup takes the data shard's ids, gathers the rows of
  its own shard masked (rows of other shards read as zero) and
  reduce-scatters the partial over ``model``: each rank ends with its
  ``flat_batch`` rows (data shard d, model index m: rows d·n_model + m).
  When the data shard's batch does not divide ``model``, the partial is
  all-reduced instead and the data shards all-gathered.
* ``"2d"`` -- rows sharded over the whole mesh: the ids are all-gathered
  over the data axes, each rank gathers its row slice masked, and one
  reduce-scatter over every axis delivers each rank its rows; the table's
  gradient stays on its owning shard (no data-axis all-reduce).

The gradient of the masked gather is autograd's scatter into the rank's
own rows; the collectives carry their transposes
(``repro_torch.dist.collectives``).  A batch that divides none of these
takes every row on every rank: the masked partial over the table's axes
is all-reduced.  The table's live layout is the caller's (``pspec``,
from ``dist.api.placed``): where a degraded mesh no longer divides the
rows, the whole table on every rank.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as nnf

from repro_torch.dist import api as dist
from repro_torch.dist import collectives as coll
from repro_torch.dist.api import P
from repro_torch.nn.embedding_backends.base import (EmbeddingBackend,
                                                    axes_entry, axes_on_mesh,
                                                    axes_tuple,
                                                    register_backend)

def _masked_rows(table_shard: torch.Tensor, ids: torch.Tensor,
                 offsets: torch.Tensor, lo: int) -> torch.Tensor:
    """The rows ``ids + offsets`` that fall in ``table_shard`` (which
    holds rows lo .. lo + len - 1); the others read as zero."""
    rows = table_shard.shape[0]
    local = ids + offsets[None, :] - lo
    hit = (local >= 0) & (local < rows)
    part = nnf.embedding(local.clamp(0, rows - 1), table_shard)
    return part.masked_fill_(~hit[..., None], 0)


def _offsets(spec, fields, device) -> torch.Tensor:
    fields = fields if fields is not None else tuple(range(spec.n_fields))
    return torch.as_tensor(spec.offsets[list(fields)], device=device)


def full_lookup_sharded_body(table_shard: torch.Tensor, idx: torch.Tensor,
                             offsets, ctx, shard_rows: int,
                             model_axis: str = "model") -> torch.Tensor:
    """Masked local gather + batch reduce-scatter over the model axis.

    table_shard: [rows/model, dim] this rank's rows.
    idx:         [B_data, F] global row ids of this rank's data shard.
    returns      [B_data/model, F, dim] -- the batch now split over model
    too.
    """
    off = torch.as_tensor(offsets, device=idx.device)
    lo = ctx.index((model_axis,)) * shard_rows
    part = _masked_rows(table_shard, idx, off, lo)
    return coll.reduce_scatter(part, ctx, (model_axis,))


class FullTableBackend(EmbeddingBackend):
    name = "full"
    local_batch = False          # lookups exchange over `model`

    def init(self, generator, spec, device, pad_rows_to: int = 1) -> dict:
        rows = spec.total_rows
        rows = ((rows + pad_rows_to - 1) // pad_rows_to) * pad_rows_to
        scale = float(1.0 / np.sqrt(spec.dim))
        table = torch.empty((rows, spec.dim), dtype=torch.float32,
                            device=generator.device)
        return {"table": table.uniform_(-scale, scale,
                                        generator=generator).to(device)}

    def lookup(self, params, spec, idx, fields=None):
        return nnf.embedding(idx + _offsets(spec, fields, idx.device),
                             params["table"])

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

    def lookup_dist(self, params, spec, idx, *, compute_dtype=None,
                    fields=None, pspec=None):
        ctx = dist.current()
        if ctx is None:
            return self.lookup(params, spec, idx, fields)
        table = params["table"]
        entry = (pspec or self.param_specs(spec, ctx.rules,
                                           mesh=ctx.mesh))["table"]
        axes = axes_tuple(entry[0]) if len(entry) else ()
        if table.shape[0] * ctx.size(axes) < spec.total_rows:
            raise ValueError(f"full: a table of {table.shape[0]} rows over "
                             f"{axes} holds fewer than {spec.total_rows}")
        if not axes:
            return self.lookup(params, spec, dist.rows(idx), fields)
        batch = idx.shape[0]
        dp = ctx.dp_axes
        n_data, n_model = ctx.dp_size, ctx.mesh.shape["model"]
        if ctx.batch_axes != dp + ("model",):
            raise ValueError(f"full: flat_batch {ctx.batch_axes} must be the "
                             f"data axes then model")
        off = _offsets(spec, fields, idx.device)
        lo = ctx.index(axes) * table.shape[0]
        if axes == dp + ("model",) and batch % (n_data * n_model) == 0:
            # 2d: every rank serves the whole batch against its row slice,
            # and one reduce-scatter over every axis hands out the rows
            ix = coll.all_gather(dist.Sharding(ctx, P(dp)).cut(idx), ctx, dp)
            tb = table if compute_dtype is None else table.to(compute_dtype)
            return coll.reduce_scatter(_masked_rows(tb, ix, off, lo), ctx,
                                       axes)
        if axes == ("model",) and batch % n_data == 0:
            ix = dist.Sharding(ctx, P(dp)).cut(idx)
            if (batch // n_data) % n_model == 0:
                return full_lookup_sharded_body(table, ix, off, ctx,
                                                table.shape[0])
            # the data shard's batch does not divide `model`: all-reduce
            # (same sum, all-reduce volume); every rank then holds every
            # row, the data shards' too
            return coll.all_gather(coll.all_reduce(
                _masked_rows(table, ix, off, lo), ctx, axes), ctx, dp)
        # nothing divides: every rank looks up every row
        return coll.all_reduce(_masked_rows(table, idx, off, lo), ctx, axes)

    def param_specs(self, spec, rules, mesh=None) -> dict:
        dp = axes_tuple(rules.get("batch"))
        rows = axes_tuple(rules.get("table_rows", "model"))
        table_axes = dp + rows if spec.placement == "2d" else rows
        table_axes = axes_on_mesh(table_axes, mesh)   # elastic: survivors
        if not table_axes:
            return {"table": P()}
        return {"table": P(axes_entry(table_axes), None)}

    def param_count(self, spec) -> int:
        return spec.total_rows * spec.dim

    def cost(self, spec, batch: int) -> dict:
        # one dim-row fetch per (example, field)
        return {"params": self.param_count(spec),
                "bytes_fetched": batch * spec.n_fields * spec.dim * 4,
                "flops": 0}


register_backend(FullTableBackend())
