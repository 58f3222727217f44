"""Embedding substrates behind one protocol: ``full``, ``robe``,
``qrobe``, ``hashed`` and ``tt``, every backend of the JAX package."""

from repro_torch.nn.embedding_backends.base import (NOT_YET_PORTED,
                                                    EmbeddingBackend,
                                                    backend_names,
                                                    get_backend,
                                                    register_backend)
from repro_torch.nn.embedding_backends.full import FullTableBackend
from repro_torch.nn.embedding_backends.hashed import HashedBackend
from repro_torch.nn.embedding_backends.qrobe import QRobeBackend
from repro_torch.nn.embedding_backends.robe import (RobeBackend,
                                                    analytic_max_fetches)
from repro_torch.nn.embedding_backends.tt import TensorTrainBackend

__all__ = ["EmbeddingBackend", "FullTableBackend", "RobeBackend",
           "QRobeBackend", "HashedBackend", "TensorTrainBackend",
           "NOT_YET_PORTED",
           "analytic_max_fetches", "backend_names", "get_backend",
           "register_backend"]
