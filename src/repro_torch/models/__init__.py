"""Models (PyTorch port of ``repro.models``; DLRM only, so far)."""
