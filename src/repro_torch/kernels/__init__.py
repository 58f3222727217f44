"""The port's kernels: Hopper CUDA kernels, their plain versions, and the
device-dispatched ops.  Nothing here builds or loads the CUDA library at
import; the first launch does (``kernels/_build.py``)."""

from repro_torch.kernels.dot_interaction import (dot_interaction_bwd_cuda,
                                                 dot_interaction_cuda)
from repro_torch.kernels.ops import (dot_interaction, qr_lookup,
                                     qrobe_lookup, robe_lookup, serve_fused,
                                     tt_lookup)
from repro_torch.kernels.qr_lookup import qr_lookup_bwd_cuda, qr_lookup_cuda
from repro_torch.kernels.qrobe_lookup import (qrobe_lookup_bwd_cuda,
                                              qrobe_lookup_cuda)
from repro_torch.kernels.robe_lookup import (robe_lookup_bwd_cuda,
                                             robe_lookup_cuda)
from repro_torch.kernels.serve_fused import serve_fused_cuda
from repro_torch.kernels.tt_lookup import tt_lookup_bwd_cuda, tt_lookup_cuda

#: every kernel wrapper of the package; each carries a ``launches`` count
CUDA_KERNELS = (robe_lookup_cuda, dot_interaction_cuda, serve_fused_cuda,
                qrobe_lookup_cuda, qr_lookup_cuda, tt_lookup_cuda,
                robe_lookup_bwd_cuda, dot_interaction_bwd_cuda,
                qrobe_lookup_bwd_cuda, qr_lookup_bwd_cuda, tt_lookup_bwd_cuda)

__all__ = ["robe_lookup", "dot_interaction", "serve_fused", "qrobe_lookup",
           "qr_lookup", "tt_lookup", "robe_lookup_cuda",
           "dot_interaction_cuda", "serve_fused_cuda", "qrobe_lookup_cuda",
           "qr_lookup_cuda", "tt_lookup_cuda", "robe_lookup_bwd_cuda",
           "dot_interaction_bwd_cuda", "qrobe_lookup_bwd_cuda",
           "qr_lookup_bwd_cuda", "tt_lookup_bwd_cuda", "CUDA_KERNELS",
           "reset_launches",
           "launch_counts"]


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in CUDA_KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {k.__name__.removesuffix("_cuda"): k.launches for k in CUDA_KERNELS}
