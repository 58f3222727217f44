"""decode_host_ms.decode: host milliseconds to issue one decode step of every row inside the program (its span `lm.decode`, the whole of `decode_step`: the embedding, every layer's attention and FFN, the head; no wait for the card), the mean over the traced window's steps."""

from lib.spans import root_ms

UNIT = "ms"


def read(ctx):
    return root_ms(ctx, "lm.decode")
