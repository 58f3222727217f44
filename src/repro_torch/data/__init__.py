"""Synthetic data streams (numpy; PyTorch port of ``repro.data``)."""

from repro_torch.data.graphs import (CsrGraph, GraphSpec, NeighborSampler,
                                     SamplerConfig, molecule_batch)
from repro_torch.data.lm_data import LmDataConfig, LmStream
from repro_torch.data.synthetic_ctr import (CtrDataConfig, CtrStream,
                                            RequestStream, poisson_arrivals,
                                            retrieval_batch)

__all__ = ["CtrDataConfig", "CtrStream", "RequestStream", "poisson_arrivals",
           "retrieval_batch", "LmDataConfig", "LmStream", "GraphSpec",
           "CsrGraph", "SamplerConfig", "NeighborSampler", "molecule_batch"]
