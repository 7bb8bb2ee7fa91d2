"""Host milliseconds per epoch in the dataset's gathers (the port's
``trainer.gather`` spans: every ``dataset.gather`` of the training
batches and of the test pass)."""


def read(view):
    epochs = view.counts.get("epochs")
    if view.trace is None or not epochs:
        return None
    s = view.trace.span_seconds("trainer.gather")
    return 1e3 * s / epochs if s > 0 else None
