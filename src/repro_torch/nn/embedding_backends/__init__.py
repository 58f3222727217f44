"""Embedding substrates behind one protocol: ``robe``, ``qrobe``,
``hashed`` and ``tt`` are ported; ``get_backend`` names the JAX package's
``full`` as not yet ported."""

from repro_torch.nn.embedding_backends.base import (NOT_YET_PORTED,
                                                    EmbeddingBackend,
                                                    backend_names,
                                                    get_backend,
                                                    register_backend)
from repro_torch.nn.embedding_backends.hashed import HashedBackend
from repro_torch.nn.embedding_backends.qrobe import QRobeBackend
from repro_torch.nn.embedding_backends.robe import (RobeBackend,
                                                    analytic_max_fetches)
from repro_torch.nn.embedding_backends.tt import TensorTrainBackend

__all__ = ["EmbeddingBackend", "RobeBackend", "QRobeBackend",
           "HashedBackend", "TensorTrainBackend", "NOT_YET_PORTED",
           "analytic_max_fetches", "backend_names", "get_backend",
           "register_backend"]
