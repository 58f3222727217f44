"""``robe`` — the paper's Random Offset Block Embedding array (PyTorch port
of ``repro.nn.embedding_backends.robe``).

One shared circular array of ``spec.robe.size`` float slots replaces every
table (``repro_torch.core.robe`` holds the hash math;
``repro_torch.kernels.ops`` the lookup and the fused serve op).  The array
is replicated, so lookups are local.  The ZeRO-3 placement
(``placement="model"``) waits for the port of distribution.
"""

from __future__ import annotations

from repro_torch.core.robe import init_memory
from repro_torch.kernels.ops import robe_lookup, serve_fused
from repro_torch.nn.embedding_backends.base import (EmbeddingBackend,
                                                    register_backend)


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
        if spec.placement == "model":
            raise NotImplementedError("robe placement='model' (ZeRO-3) is "
                                      "not yet ported")

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
        """
        return serve_fused(params["memory"], idx, bot,
                           tuple(range(spec.n_fields)), spec.dim, spec.robe)

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
