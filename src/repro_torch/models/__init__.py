"""Models (PyTorch port of ``repro.models``): the recsys family, the LM
family (``transformer``) and GatedGCN."""
