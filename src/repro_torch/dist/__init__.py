"""Distribution over ``torch.distributed`` (PyTorch port of ``repro.dist``).

``repro_torch.dist.api`` holds the mesh context (``DistContext`` / ``use``
/ ``current`` / ``swap``), the port's ``P`` specs and the layout helpers
(``resolve_spec``, ``prune_specs``, ``place`` / ``gather``, ``shard``,
``batch_rows``); ``repro_torch.dist.collectives`` the collectives with
their transposes; ``repro_torch.dist.param_specs`` the spec trees of the
parameter families (embedding subtrees delegated to their backend's own
``param_specs``, mirrored optimizer state).  Meshes are built by
``repro_torch.launch.mesh``.
"""

from repro_torch.dist.api import (DistContext, P, current, default_rules,
                                  gather, place, shard, shard_if_divisible,
                                  use)
from repro_torch.dist.param_specs import (recsys_specs, replicated_specs,
                                          state_specs, transformer_specs)

__all__ = ["DistContext", "P", "current", "default_rules", "gather",
           "place", "shard", "shard_if_divisible", "use", "recsys_specs",
           "replicated_specs", "state_specs", "transformer_specs"]
