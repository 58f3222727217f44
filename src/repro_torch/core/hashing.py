"""Universal hashing for ROBE memory allocation (PyTorch).

The same 2-universal Mersenne-prime family as the JAX package:

    P = 2^31 - 1
    h(t, k) = ((a_t*t + a2*k2 + a1*k1 + a0*k0 + b) mod P) mod m

where ``k0 = k & P``, ``k1 = (k >> 31) & P`` and ``k2 = k >> 62`` are the
31-bit digits of the 64-bit key ``k``.  The coefficients come from
``np.random.RandomState`` exactly as the JAX package draws them, so one
``(seed, m, salt)`` names the same hash in both packages.

PyTorch has int64 everywhere, so the hash is computed in int64 directly.
Each coefficient x digit product is below 2^62 but four of them can sum
past 2^63, so every product is reduced mod P before the sum; the result is
the same residue as the unsigned 64-bit sum the JAX limb code forms.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

M31 = 0x7FFFFFFF  # 2^31 - 1


@dataclasses.dataclass(frozen=True)
class UHash:
    """One member of the 2-universal family, fixed by integer coefficients.

    Hashes a (table_id, key64) pair to [0, m).  ``m`` must be < 2^31.
    """
    a_table: int
    a2: int
    a1: int
    a0: int
    b: int
    m: int

    @staticmethod
    def draw(seed: int, m: int, salt: int = 0) -> "UHash":
        if not (0 < m < M31):
            raise ValueError(f"m must be in (0, 2^31-1), got {m}")
        rs = np.random.RandomState((seed * 0x9E3779B1 + salt * 0x85EBCA77)
                                   % (2 ** 31))
        draw = lambda: int(rs.randint(1, M31, dtype=np.int64))
        return UHash(a_table=draw(), a2=draw(), a1=draw(), a0=draw(),
                     b=int(rs.randint(0, M31, dtype=np.int64)), m=m)

    def coefficients(self) -> tuple:
        """(a_table, a2, a1, a0, b, m): the order the CUDA kernels take."""
        return (self.a_table, self.a2, self.a1, self.a0, self.b, self.m)

    def __call__(self, table_id: torch.Tensor, key: torch.Tensor
                 ) -> torch.Tensor:
        """Hash int64 ``key`` (>= 0, < 2^63) under int64 ``table_id``
        (broadcastable) -> int64 in [0, m)."""
        acc = ((self.a_table * table_id) % M31
               + (self.a2 * (key >> 62)) % M31
               + (self.a1 * ((key >> 31) & M31)) % M31
               + (self.a0 * (key & M31)) % M31
               + self.b)
        return (acc % M31) % self.m


def sign_hash(h: UHash, table_id: torch.Tensor, key: torch.Tensor
              ) -> torch.Tensor:
    """±1 sign from an independent hash (parity of the M31 residue)."""
    v = h(table_id, key)
    return (1 - 2 * (v & 1)).to(torch.float32)
