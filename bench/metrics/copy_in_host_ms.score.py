"""copy_in_host_ms.score: host milliseconds of the server's copies of a batch's dense features and ids to the card (the program's span `server.copy_in`), the mean over the traced window's batches."""

from lib.spans import child_ms

UNIT = "ms"


def read(ctx):
    return child_ms(ctx, "server.score", "server.copy_in")
