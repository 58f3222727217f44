"""Training (PyTorch port of ``repro.train``): optimizers, the train-step
builder and run loop (on one device or a ``repro_torch.dist`` mesh),
gradient compression, checkpoints, metrics, the online trainer, and the
elastic re-slice with its fault-injection harness (``elastic``)."""
