"""ROBE hash and array (PyTorch port of ``repro.core``)."""

from repro_torch.core.hashing import M31, UHash, sign_hash
from repro_torch.core.robe import (RobeSpec, init_memory, robe_lookup,
                                   robe_lookup_bag, robe_signs, robe_slots,
                                   sketch_vector, unsketch_vector)

__all__ = ["M31", "UHash", "sign_hash", "RobeSpec", "init_memory",
           "robe_slots", "robe_signs", "robe_lookup", "robe_lookup_bag",
           "sketch_vector", "unsketch_vector"]
