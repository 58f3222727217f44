"""copy_out_host_ms.rank: host milliseconds of a request's scores back to the host, the wait for the card included (the program's span `server.copy_out`), the mean over the traced window's requests."""

from lib.spans import child_ms

UNIT = "ms"


def read(ctx):
    return child_ms(ctx, "server.score", "server.copy_out")
