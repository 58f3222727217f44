"""Model configurations (PyTorch port of ``repro.configs``)."""

from repro_torch.configs.registry import (RECSYS_SHAPES, ArchBundle,
                                          get_arch, register)

__all__ = ["RECSYS_SHAPES", "ArchBundle", "get_arch", "register"]
