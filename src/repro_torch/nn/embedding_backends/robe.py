"""``robe`` — the paper's Random Offset Block Embedding array (PyTorch port
of ``repro.nn.embedding_backends.robe``).

One shared circular array of ``spec.robe.size`` float slots replaces every
table (``repro_torch.core.robe`` holds the hash math;
``repro_torch.kernels.ops`` the lookup and the fused serve op).
Placement (``spec.placement``) under a ``repro_torch.dist`` context:

* ``"default"`` / ``"replicated"`` -- the array is small (~100 MB for the
  paper's CriteoTB model), so it is replicated and lookups are local on
  the rank's ``flat_batch`` rows: no embedding collective, only the
  |M|-sized gradient all-reduce.
* ``"model"`` -- ZeRO-3, for arrays beyond a replica's memory: the array
  is sharded over ``model`` and all-gathered once per lookup before the
  local ``robe_lookup`` kernel; the gather's transpose reduce-scatters the
  slot gradients (``robe_lookup_bwd`` into the gathered array's gradient)
  back to their owning shard.  The fused serve kernel declines it.
"""

from __future__ import annotations

from repro_torch.core.robe import init_memory
from repro_torch.dist import api as dist
from repro_torch.dist import collectives as coll
from repro_torch.dist.api import P
from repro_torch.kernels.ops import robe_lookup, serve_fused
from repro_torch.nn.embedding_backends.base import (EmbeddingBackend,
                                                    axes_entry, axes_on_mesh,
                                                    axes_tuple,
                                                    register_backend)


def robe_allgather_body(mem_shard, ctx, model_axis="model"):
    """ZeRO-3: gather the ``model``-sharded ROBE array before the local
    lookups (``model_axis``: an axis name or a tuple of them).  Autograd
    transposes the tiled all-gather into a reduce-scatter: slot gradients
    reduce back to their owning shard."""
    return coll.all_gather(mem_shard, ctx, model_axis)


def analytic_max_fetches(d: int, z: int, bus: int) -> float:
    """Paper Table 1 bound: max B-sized bus fetches per d-dim row at block
    size Z.  The substrate's memory-traffic model (see ``cost``)."""
    if z >= d:
        return d / bus + 2
    if z >= bus:
        return d / bus + d / z
    return 2 * d / z


class RobeBackend(EmbeddingBackend):
    name = "robe"
    #: declines the serving tier's hot-row cache: the whole ROBE array is
    #: cache-resident by construction, which is the paper's serving claim
    cacheable_rows = None

    def validate(self, spec) -> None:
        if spec.robe is None:
            raise ValueError("robe spec required for kind='robe'")

    def init(self, generator, spec, device, pad_rows_to: int = 1) -> dict:
        return {"memory": init_memory(generator, spec.robe, device)}

    def lookup(self, params, spec, idx, fields=None):
        fields = fields if fields is not None else tuple(range(spec.n_fields))
        return robe_lookup(params["memory"], idx, tuple(fields), spec.dim,
                           spec.robe)

    def fused_serve(self, params, spec, idx, bot):
        """One-pass serve kernel: multi-field lookup -> bag pooling ->
        dot-interaction gram (``kernels.ops.serve_fused``); no [B, F, D]
        intermediate reaches device memory.

        idx [B, F] (or [B, F, bag], -1-padded), bot [B, dim] dense bottom-
        MLP output -> [B, (F+1)·F/2] interaction triangle in bot's dtype.
        Under a mesh ``idx`` is the global batch and ``bot`` the rank's
        rows of it; returns None under the ZeRO-3 placement (the array is
        sharded: callers take the gather-per-lookup path).
        """
        if spec.placement == "model":
            return None
        return serve_fused(params["memory"], dist.rows(idx), bot,
                           tuple(range(spec.n_fields)), spec.dim, spec.robe)

    def lookup_dist(self, params, spec, idx, *, compute_dtype=None,
                    fields=None, pspec=None):
        ctx = dist.current()
        if ctx is None or spec.placement != "model":
            return super().lookup_dist(params, spec, idx,
                                       compute_dtype=compute_dtype,
                                       fields=fields, pspec=pspec)
        # ZeRO-3: the array sharded over `model`, gathered per lookup; a
        # degraded mesh that no longer divides it holds it whole
        mem = params["memory"]
        entry = (pspec or self.param_specs(spec, ctx.rules,
                                           mesh=ctx.mesh))["memory"]
        axes = axes_tuple(entry[0]) if len(entry) else ()
        if mem.shape[0] * ctx.size(axes) != spec.robe.size:
            raise ValueError(f"robe: an array of {mem.shape[0]} slots over "
                             f"{axes} is not the {spec.robe.size} slots")
        if axes:
            mem = robe_allgather_body(mem, ctx, axes)
        fields = fields if fields is not None else tuple(range(spec.n_fields))
        return robe_lookup(mem, dist.rows(idx), tuple(fields), spec.dim,
                           spec.robe)

    def param_specs(self, spec, rules, mesh=None) -> dict:
        if spec.placement == "model":
            # ZeRO-3: on a degraded mesh the array re-shards over the
            # surviving model axis; no surviving axis: replicated
            rows = axes_on_mesh(axes_tuple(rules.get("table_rows", "model")),
                                mesh)
            if rows:
                return {"memory": P(axes_entry(rows))}
        return {"memory": P()}

    def param_count(self, spec) -> int:
        return spec.robe.size

    def cost(self, spec, batch: int, bus: int = 16) -> dict:
        # block-coalesced reads: <= analytic_max_fetches bus lines per row
        # (paper Table 1); hashing is ~10 int ops per element, plus the
        # optional sign multiply
        z = spec.robe.block_size
        fetches = analytic_max_fetches(spec.dim, z, bus)
        flops = 10 * batch * spec.n_fields * spec.dim
        if spec.robe.use_sign:
            flops += batch * spec.n_fields * spec.dim
        return {"params": self.param_count(spec),
                "bytes_fetched": int(batch * spec.n_fields * fetches
                                     * bus * 4),
                "flops": flops}


register_backend(RobeBackend())
