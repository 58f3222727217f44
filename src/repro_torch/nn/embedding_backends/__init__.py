"""Embedding substrates behind one protocol.  Only ``robe`` is ported;
``get_backend`` names the JAX package's other four as not yet ported."""

from repro_torch.nn.embedding_backends.base import (NOT_YET_PORTED,
                                                    EmbeddingBackend,
                                                    backend_names,
                                                    get_backend,
                                                    register_backend)
from repro_torch.nn.embedding_backends.robe import (RobeBackend,
                                                    analytic_max_fetches)

__all__ = ["EmbeddingBackend", "RobeBackend", "NOT_YET_PORTED",
           "analytic_max_fetches", "backend_names", "get_backend",
           "register_backend"]
