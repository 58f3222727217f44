"""Training (PyTorch port of ``repro.train``): optimizers, the train-step
builder and run loop, checkpoints, metrics, the online trainer and the
fault-injection harness (``elastic``'s ``FaultClock``/``FaultPlan``).
Gradient compression and the mesh re-slice are not yet ported."""
