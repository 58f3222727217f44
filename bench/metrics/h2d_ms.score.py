"""h2d_ms.score: device milliseconds of host-to-device copies a batch, from the trace: the server's copies of the dense features and ids."""

from lib.readers import ms_per_unit

UNIT = "ms"
KERNELS = ("Memcpy HtoD",)


def read(ctx):
    return ms_per_unit(ctx, KERNELS)
