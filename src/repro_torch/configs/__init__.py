"""Model configurations (PyTorch port of ``repro.configs``)."""

from repro_torch.configs.registry import (ARCH_IDS, GNN_SHAPES, LM_SHAPES,
                                          RECSYS_SHAPES, ArchBundle,
                                          all_arch_ids, get_arch, register)

__all__ = ["ARCH_IDS", "GNN_SHAPES", "LM_SHAPES", "RECSYS_SHAPES",
           "ArchBundle", "all_arch_ids",
           "get_arch", "register"]
