"""model_host_ms.rank: host milliseconds of a request's `serve_scores` under inference mode, launches and host work of the DLRM (the program's span `server.model`), the mean over the traced window's requests."""

from lib.spans import child_ms

UNIT = "ms"


def read(ctx):
    return child_ms(ctx, "server.score", "server.model")
