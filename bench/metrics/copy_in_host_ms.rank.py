"""copy_in_host_ms.rank: host milliseconds of the server's copies of a request's dense features and ids to the card (the program's span `server.copy_in`), the mean over the traced window's requests."""

from lib.spans import child_ms

UNIT = "ms"


def read(ctx):
    return child_ms(ctx, "server.score", "server.copy_in")
