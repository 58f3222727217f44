"""ROBE — Random Offset Block Embedding Array (paper §2), in PyTorch.

A single 1-D circular array ``M`` of ``spec.size`` float slots replaces every
embedding table in the model.  Element ``i`` of row ``x`` of table ``e`` is
stored at

    slot(e, x, i) = ( h(e, Z_id) + Z_off ) mod |M|
    Z_id  = (x*d + i) >> log2(Z)          # block id  (Eq. 3)
    Z_off = (x*d + i) &  (Z - 1)          # offset inside block

with ``h`` a 2-universal hash into [0, |M|) and ``Z`` a power of two.  The
element index ``x*d + i`` passes 2^32 at full width (40M rows x 128), so
it is carried in int64.  These plain functions are the semantics the
Hopper kernels in ``repro_torch.kernels`` are held against.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.hashing import UHash

__all__ = ["RobeSpec", "init_memory", "robe_slots", "robe_signs",
           "robe_lookup", "robe_lookup_bag", "sketch_vector",
           "unsketch_vector"]


@dataclasses.dataclass(frozen=True)
class RobeSpec:
    """Static configuration of one ROBE array."""
    size: int                 # |M|: number of float32 slots
    block_size: int = 32      # Z (power of two)
    seed: int = 0
    use_sign: bool = False    # paper's optional g(e,x,i) ∈ {±1}
    init_scale: float = 0.01

    def __post_init__(self):
        z = self.block_size
        if z < 1 or (z & (z - 1)) != 0:
            raise ValueError(f"block_size must be a power of two, got {z}")
        if self.size <= z:
            raise ValueError("ROBE array must be larger than one block")

    @property
    def log2_z(self) -> int:
        return int(self.block_size).bit_length() - 1

    def hash_fn(self) -> UHash:
        return UHash.draw(self.seed, self.size, salt=1)

    def sign_fn(self) -> UHash:
        return UHash.draw(self.seed, 2, salt=2)

    @property
    def bytes(self) -> int:
        return self.size * 4


def init_memory(generator: torch.Generator, spec: RobeSpec,
                device, dtype=torch.float32) -> torch.Tensor:
    """The learnable array M (the entire embedding memory of the model),
    drawn on the generator's device and placed on ``device``."""
    m = torch.randn(spec.size, generator=generator, dtype=torch.float32,
                    device=generator.device) * spec.init_scale
    return m.to(device=device, dtype=dtype)


def _element_index(rows: torch.Tensor, dim: int) -> torch.Tensor:
    """int64 x*d + i for i in [0, dim), shape rows.shape + (dim,); rows are
    read as uint32, as the JAX package casts them."""
    x = rows.to(torch.int64) & 0xFFFFFFFF
    i = torch.arange(dim, dtype=torch.int64, device=rows.device)
    return x[..., None] * dim + i


def _table_ids(table_ids, rows: torch.Tensor) -> torch.Tensor:
    t = torch.as_tensor(table_ids, dtype=torch.int64, device=rows.device)
    return torch.broadcast_to(t, rows.shape)[..., None]


def robe_slots(spec: RobeSpec, table_ids, rows: torch.Tensor,
               dim: int) -> torch.Tensor:
    """Slot indices into M for each element of each requested row.

    table_ids: int or int tensor broadcastable to ``rows`` (table id e).
    rows:      int tensor [...] of row indices x.
    returns:   int64 tensor [..., dim] of slots in [0, |M|).
    """
    k = _element_index(rows, dim)
    lz = spec.log2_z
    base = spec.hash_fn()(_table_ids(table_ids, rows), k >> lz)
    slot = base + (k & (spec.block_size - 1))
    return torch.where(slot >= spec.size, slot - spec.size, slot)


def robe_signs(spec: RobeSpec, table_ids, rows: torch.Tensor,
               dim: int) -> torch.Tensor:
    """±1 signs g(e,x,i) (independent hash), float32 [..., dim]."""
    bit = spec.sign_fn()(_table_ids(table_ids, rows),
                         _element_index(rows, dim))
    return (1 - 2 * bit).to(torch.float32)


def robe_lookup(memory: torch.Tensor, spec: RobeSpec, table_ids,
                rows: torch.Tensor, dim: int) -> torch.Tensor:
    """Embedding lookup through the ROBE array (plain path).

    memory: [|M|] learnable array.
    returns [..., dim] embeddings, dtype of ``memory``.
    """
    emb = memory[robe_slots(spec, table_ids, rows, dim)]
    if spec.use_sign:
        emb = emb * robe_signs(spec, table_ids, rows, dim).to(emb.dtype)
    return emb


def robe_lookup_bag(memory: torch.Tensor, spec: RobeSpec, table_ids,
                    rows: torch.Tensor, dim: int,
                    weights: Optional[torch.Tensor] = None,
                    combiner: str = "sum") -> torch.Tensor:
    """EmbeddingBag through ROBE: multi-hot rows [..., bag] -> pooled
    [..., dim].  ``rows[..., bag]`` may be padded with -1 (masked out);
    ``table_ids`` is per field (broadcast against ``rows[..., 0]``)."""
    mask = rows >= 0
    safe = torch.where(mask, rows, torch.zeros_like(rows))
    tids = torch.as_tensor(table_ids, dtype=torch.int64,
                           device=rows.device)[..., None]
    emb = robe_lookup(memory, spec, tids, safe, dim)      # [..., bag, dim]
    w = mask.to(emb.dtype)
    if weights is not None:
        w = w * weights.to(emb.dtype)
    out = (emb * w[..., None]).sum(dim=-2)
    if combiner == "mean":
        # true weighted mean: fractional weight mass < 1 must not be
        # clamped away; empty bags (mass 0) pool to zero
        mass = w.sum(dim=-1, keepdim=True)
        out = torch.where(mass > 0,
                          out / torch.where(mass > 0, mass,
                                            torch.ones_like(mass)),
                          torch.zeros_like(out))
    elif combiner != "sum":
        raise ValueError(f"unknown combiner {combiner}")
    return out


# ---------------------------------------------------------------------------
# Sketch interface of the theory checks (paper §3): project an explicit
# parameter vector θ ∈ R^n into R^m with the ROBE-Z sketching matrix.
# ---------------------------------------------------------------------------

def _sketch_map(n: int, spec: RobeSpec) -> tuple:
    """(slots, signs) of θ's n elements as row 0's elements of table 0,
    each a row of width 1 (numpy int64, f32)."""
    rows = torch.arange(n, dtype=torch.int64)
    slots = robe_slots(spec, 0, rows, 1)[:, 0].numpy()
    s = robe_signs(spec, 0, rows, 1)[:, 0].numpy() if spec.use_sign \
        else np.ones(n)
    return slots, s


def sketch_vector(theta: np.ndarray, spec: RobeSpec) -> np.ndarray:
    """ROBE-Z sketch θ̂ ∈ R^m of θ ∈ R^n (numpy, f64; analysis helper).

    Equivalent to multiplying by the sketching matrix of Fig. 3b: every
    element lands in its hashed slot (sign-weighted if use_sign).
    """
    slots, s = _sketch_map(theta.shape[0], spec)
    out = np.zeros(spec.size, dtype=np.float64)
    np.add.at(out, slots, theta * s)
    return out


def unsketch_vector(mem: np.ndarray, n: int, spec: RobeSpec) -> np.ndarray:
    """Read every θ_i back out of the sketch (the lookup direction)."""
    slots, s = _sketch_map(n, spec)
    return mem[slots] * s
