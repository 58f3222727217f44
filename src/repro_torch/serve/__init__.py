"""Serving (PyTorch port of ``repro.serve``; the embedding server only)."""

from repro_torch.serve.server import EmbeddingServer, ServerConfig

__all__ = ["EmbeddingServer", "ServerConfig"]
