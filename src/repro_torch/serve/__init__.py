"""The serving tier (PyTorch port of ``repro.serve``): async routing,
hot-row caching, multi-substrate scoring, and traffic replay.

* ``serving``   — sync ``MicroBatcher`` + ``latency_profile``/``percentile``
* ``router``    — ``DeadlineBatcher``/``FixedBatcher`` policies and the
  ``AsyncRouter`` front-end (admission, deadline close-out, load shedding)
* ``hot_cache`` — ``CountMinSketch`` + ``HotRowCache`` (fronts the
  fetch-bound substrates via the ``cacheable_rows`` backend hook)
* ``server``    — ``EmbeddingServer``: every substrate resident, model
  pushes from an ``OnlineTrainer``'s publishes
* ``fleet``     — ``ReplicaFleet``: N replicas behind one admission path
  (shed → retry-on-replica) with staggered model rollouts
* ``replay``    — virtual-clock open-loop traffic replay (single server or
  fleet)

The light names are re-exported here, as the JAX package's; ``server``,
``fleet`` and ``replay`` stay submodule imports.
"""

from repro_torch.serve.hot_cache import CountMinSketch, HotRowCache
from repro_torch.serve.router import (AsyncRouter, DeadlineBatcher,
                                      FixedBatcher, LoadShedError,
                                      RouterConfig, stack_and_pad)
from repro_torch.serve.serving import (MicroBatcher, latency_profile,
                                       percentile)

__all__ = ["AsyncRouter", "CountMinSketch", "DeadlineBatcher",
           "FixedBatcher", "HotRowCache", "LoadShedError", "MicroBatcher",
           "RouterConfig", "latency_profile", "percentile", "stack_and_pad"]
