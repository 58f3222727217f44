"""h2d_ms.rank: device milliseconds of host-to-device copies a request, from the trace: the server's copies of the dense features and ids."""

from lib.readers import ms_per_unit

UNIT = "ms"
KERNELS = ("Memcpy HtoD",)


def read(ctx):
    return ms_per_unit(ctx, KERNELS)
