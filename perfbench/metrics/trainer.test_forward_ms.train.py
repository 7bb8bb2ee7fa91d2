"""Host milliseconds per epoch in the test pass's batches (the port's
``trainer.test.forward`` spans: each batch's copy and forward)."""


def read(view):
    epochs = view.counts.get("epochs")
    if view.trace is None or not epochs:
        return None
    s = view.trace.span_seconds("trainer.test.forward")
    return 1e3 * s / epochs if s > 0 else None
