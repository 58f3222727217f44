"""Synthetic data streams (numpy; PyTorch port of ``repro.data``)."""

from repro_torch.data.synthetic_ctr import (CtrDataConfig, CtrStream,
                                            RequestStream, poisson_arrivals,
                                            retrieval_batch)

__all__ = ["CtrDataConfig", "CtrStream", "RequestStream", "poisson_arrivals",
           "retrieval_batch"]
