"""Functional NN substrate (PyTorch port of ``repro.nn``)."""
