"""Training (PyTorch port of ``repro.train``): optimizers, the train-step
builder and run loop, checkpoints and metrics.  Gradient compression,
online training and elastic re-slice are not yet ported."""
