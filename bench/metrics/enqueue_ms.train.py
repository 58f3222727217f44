"""enqueue_ms.train: the host's milliseconds to issue one step (the benchmark's own span around each step_fn call, with its batch's copy to the card and no synchronize), the mean over the traced window."""

UNIT = "ms"


def read(ctx):
    enq = ctx.win.enqueue
    return 1e3 * sum(enq) / len(enq) if enq else None
