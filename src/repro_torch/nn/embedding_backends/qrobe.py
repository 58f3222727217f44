"""``qrobe`` — the ROBE array stored as int8 with learned per-group scales
(PyTorch port of ``repro.nn.embedding_backends.qrobe``).

The shared circular array is kept as int8 ``codes`` plus one f32 ``scale``
per ``GROUP_SIZE``-slot group.  A lookup gathers codes through the
unchanged ROBE hash and dequantizes inside the kernel
(``codes_f32 · scale_f32[slot >> GROUP_LOG2] · sign``, one rounding into
``scale.dtype``), so the lookup reads a byte per weight instead of four.

Training is the JAX package's: the scales are ordinary float leaves, whose
gradient the op's backward delivers (``Σ g · sign · code`` over each
group).  The int8 codes take no gradient; the params hold the f32
``delta`` carrier of the straight-through estimator instead, zero between
training steps but part of the lookup, which adds ``delta[slot] · sign``
(on the card in the same ``qrobe_lookup`` launch), so that its gradient
is the memory cotangent of the dequantized array (on the card from the
same ``qrobe_lookup_bwd`` launch as the scales').  The optimizer updates
``delta`` like any float leaf, and the post-step :meth:`project` folds
``codes · scale + delta`` back into int8 codes under the updated scales
and re-zeroes ``delta``.
``fused_serve`` and ``cacheable_rows`` are declined, as in the JAX
package: the serve kernel and the hot-row cache speak f32 memories.
"""

from __future__ import annotations

import torch

from repro_torch.core.robe import init_memory
from repro_torch.dist.api import P
from repro_torch.kernels.ops import qrobe_lookup
from repro_torch.nn.embedding_backends.base import (EmbeddingBackend,
                                                    register_backend)
from repro_torch.nn.embedding_backends.robe import analytic_max_fetches

#: slots per learned scale (a power of two: the kernel indexes scales with a
#: shift, never a divide)
GROUP_SIZE = 256
GROUP_LOG2 = GROUP_SIZE.bit_length() - 1
#: scales below this are clamped during (re)quantization: a collapsed scale
#: would send every code to ±127 and freeze the group
SCALE_FLOOR = 1e-8


def n_groups(size: int) -> int:
    return -(-size // GROUP_SIZE)


def _safe_scale(scale: torch.Tensor) -> torch.Tensor:
    """Sign-preserving divide-safe scales (|s| >= SCALE_FLOOR), f32."""
    s = scale.to(torch.float32)
    mag = torch.clamp_min(s.abs(), SCALE_FLOOR)
    return torch.where(s < 0, -mag, mag)


def _expand(scale: torch.Tensor, size: int) -> torch.Tensor:
    """Per-group scales -> per-slot f32 scales of length ``size``."""
    gidx = torch.arange(size, device=scale.device) >> GROUP_LOG2
    return scale.to(torch.float32)[gidx]


def quantize_array(w: torch.Tensor, scale: torch.Tensor) -> tuple:
    """f32 array -> (int8 codes, the scales used): round half to even (as
    ``jnp.round``) against the floor-guarded per-group scales, then a
    saturating clip at ±127."""
    s = _safe_scale(scale)
    q = torch.round(w.to(torch.float32) / _expand(s, w.shape[0]))
    return q.clamp(-127, 127).to(torch.int8), s


class QRobeBackend(EmbeddingBackend):
    name = "qrobe"
    fused_serve = None           # declined: serve_fused speaks f32 memories
    cacheable_rows = None        # declined, as robe: the array IS the cache

    def validate(self, spec) -> None:
        if spec.robe is None:
            raise ValueError("robe spec required for kind='qrobe'")

    def init(self, generator, spec, device, pad_rows_to: int = 1) -> dict:
        # robe's init distribution, then max-abs per-group calibration of
        # the initial scales
        w = init_memory(generator, spec.robe, device)
        size = spec.robe.size
        ng = n_groups(size)
        padded = torch.zeros(ng * GROUP_SIZE, dtype=torch.float32,
                             device=w.device)
        padded[:size] = w
        gmax = padded.view(ng, GROUP_SIZE).abs().amax(dim=1)
        codes, scale = quantize_array(w, torch.clamp_min(gmax / 127.0,
                                                         SCALE_FLOOR))
        return {"codes": codes, "scale": scale,
                "delta": torch.zeros(size, dtype=torch.float32,
                                     device=w.device)}

    def project(self, params, spec) -> dict:
        """Post-optimizer projection (the JAX package's ALPT fold):
        dequantize with the OLD codes, add the optimizer's delta update,
        requantize under the (gradient-updated) scales and re-zero the
        carrier.  Saturates at ±127; the scale floor keeps collapsed groups
        recoverable.  Plain torch ops, bit for bit the JAX package's (one
        rounding each for the product, the sum and the quotient, and
        ``torch.round`` halves to even, as ``jnp.round``)."""
        size = spec.robe.size
        w = (params["codes"].to(torch.float32)
             * _expand(params["scale"], size)
             + params["delta"].to(torch.float32))
        codes, scale = quantize_array(w, params["scale"])
        return {"codes": codes, "scale": scale.to(params["scale"].dtype),
                "delta": torch.zeros_like(params["delta"])}

    def lookup(self, params, spec, idx, fields=None):
        fields = tuple(fields if fields is not None
                       else range(spec.n_fields))
        # with the straight-through carrier's term, delta[slot] · sign,
        # added in the same launch
        return qrobe_lookup(params["codes"], params["scale"], idx, fields,
                            spec.dim, spec.robe, GROUP_LOG2,
                            delta=params["delta"])

    def param_specs(self, spec, rules, mesh=None) -> dict:
        # codes and scales are small (a quarter of the f32 robe array's
        # bytes): replicated everywhere, like the default robe placement
        return {"codes": P(), "scale": P(), "delta": P()}

    def param_count(self, spec) -> int:
        # the serving model: int8 codes + per-group scales; delta is a
        # training-time carrier, zero between steps, and never ships
        return spec.robe.size + n_groups(spec.robe.size)

    def cost(self, spec, batch: int, bus: int = 16) -> dict:
        # robe's coalesced-fetch bound at 1 byte per element instead of 4,
        # plus about one f32 scale line per row
        z = spec.robe.block_size
        fetches = analytic_max_fetches(spec.dim, z, bus)
        flops = 10 * batch * spec.n_fields * spec.dim
        flops += batch * spec.n_fields * spec.dim      # the dequant multiply
        if spec.robe.use_sign:
            flops += batch * spec.n_fields * spec.dim
        return {"params": self.param_count(spec),
                "bytes_fetched": int(batch * spec.n_fields
                                     * (fetches * bus * 1 + 4)),
                "flops": flops}


register_backend(QRobeBackend())
