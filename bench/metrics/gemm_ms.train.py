"""gemm_ms.train: device milliseconds a step in cuBLAS's GEMM kernels (the MLPs and, in xDeepFM, the CIN's products), from the trace."""

from lib.readers import ms_per_unit

UNIT = "ms"
KERNELS = ("gemm", "Gemm", "cutlass", "xmma", "sm90_", "cublas", "Kernel2", "nvjet")


def read(ctx):
    return ms_per_unit(ctx, KERNELS)
