"""The ROBE slot and sign arithmetic the reference needs, plain PyTorch.

A frozen copy of ``UHash`` (``src/repro_torch/core/hashing.py``) and of
``robe_slots`` / ``robe_signs`` (``src/repro_torch/core/robe.py``) at
commit aa881b5.  Element ``i`` of row ``x`` of table ``e`` lives at

    slot(e, x, i) = (h(e, (x*d + i) >> log2 Z) + ((x*d + i) & (Z - 1))) mod |M|

with ``h`` the 2-universal Mersenne-prime hash
``((a_t*e + a2*k2 + a1*k1 + a0*k0 + b) mod P) mod |M|`` over the 31-bit
digits of the 64-bit key, its coefficients drawn by
``np.random.RandomState`` from (seed, |M|, salt).  Nothing here imports
the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

M31 = 0x7FFFFFFF  # 2^31 - 1


@dataclasses.dataclass(frozen=True)
class UHash:
    a_table: int
    a2: int
    a1: int
    a0: int
    b: int
    m: int

    @staticmethod
    def draw(seed: int, m: int, salt: int = 0) -> "UHash":
        rs = np.random.RandomState((seed * 0x9E3779B1 + salt * 0x85EBCA77)
                                   % (2 ** 31))
        draw = lambda: int(rs.randint(1, M31, dtype=np.int64))
        return UHash(a_table=draw(), a2=draw(), a1=draw(), a0=draw(),
                     b=int(rs.randint(0, M31, dtype=np.int64)), m=m)

    def __call__(self, table_id: torch.Tensor, key: torch.Tensor
                 ) -> torch.Tensor:
        acc = ((self.a_table * table_id) % M31
               + (self.a2 * (key >> 62)) % M31
               + (self.a1 * ((key >> 31) & M31)) % M31
               + (self.a0 * (key & M31)) % M31
               + self.b)
        return (acc % M31) % self.m


@dataclasses.dataclass(frozen=True)
class Robe:
    """One ROBE array: |M| slots, block Z, hash seed, optional signs."""
    size: int
    block: int
    seed: int
    use_sign: bool = False

    @property
    def log2_z(self) -> int:
        return int(self.block).bit_length() - 1

    def _keys(self, rows: torch.Tensor, dim: int) -> torch.Tensor:
        x = rows.to(torch.int64) & 0xFFFFFFFF
        i = torch.arange(dim, dtype=torch.int64, device=rows.device)
        return x[..., None] * dim + i

    def slots(self, table_ids: torch.Tensor, rows: torch.Tensor,
              dim: int) -> torch.Tensor:
        """int64 [..., dim] slots of ``rows`` [...] under per-entry
        ``table_ids`` (broadcastable to ``rows``)."""
        k = self._keys(rows, dim)
        t = torch.broadcast_to(table_ids.to(torch.int64), rows.shape)[..., None]
        base = UHash.draw(self.seed, self.size, salt=1)(t, k >> self.log2_z)
        slot = base + (k & (self.block - 1))
        return torch.where(slot >= self.size, slot - self.size, slot)

    def signs(self, table_ids: torch.Tensor, rows: torch.Tensor,
              dim: int) -> torch.Tensor:
        k = self._keys(rows, dim)
        t = torch.broadcast_to(table_ids.to(torch.int64), rows.shape)[..., None]
        bit = UHash.draw(self.seed, 2, salt=2)(t, k)
        return (1 - 2 * bit).to(torch.float32)

    def lookup(self, memory: torch.Tensor, rows: torch.Tensor,
               dim: int) -> torch.Tensor:
        """[B, F] per-field rows (field f is table f) -> [B, F, dim]."""
        tids = torch.arange(rows.shape[1], device=rows.device)[None, :]
        emb = memory[self.slots(tids, rows, dim)]
        if self.use_sign:
            emb = emb * self.signs(tids, rows, dim)
        return emb

    def touched(self, rows: torch.Tensor, dim: int,
                chunk: int = 8192) -> int:
        """How many distinct slots of M a lookup of ``rows`` [B, F] reads."""
        seen = torch.zeros(self.size, dtype=torch.bool, device=rows.device)
        tids = torch.arange(rows.shape[1], device=rows.device)[None, :]
        for s in range(0, rows.shape[0], chunk):
            seen[self.slots(tids, rows[s:s + chunk], dim)] = True
        return int(seen.sum())
