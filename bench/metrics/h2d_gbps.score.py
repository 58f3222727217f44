"""h2d_gbps.score: GB/s of the server's copies to the card: the bytes the program counts in its `server.copy_in` spans over the window (`h2d_bytes`) over the device seconds of host-to-device copies in the trace; None without such copies (the CPU)."""

from lib.readers import matcher
from lib.spans import child_count

UNIT = "GB/s"
KERNELS = ("Memcpy HtoD",)


def read(ctx):
    seconds = ctx.trace.seconds(matcher(KERNELS))
    if not seconds:
        return None
    moved = child_count(ctx, "server.score", "server.copy_in", "h2d_bytes")
    return None if moved is None else moved / seconds * 1e-9
