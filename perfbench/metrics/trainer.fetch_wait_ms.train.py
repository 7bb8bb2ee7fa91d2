"""Host milliseconds per epoch in fetches from the card (the port's
``trainer.fetch`` spans: the train and test metrics' one fetch each, which
waits for the work launched before it; a checkpoint's state fetch is
``trainer.checkpoint.fetch``, inside ``trainer.checkpoint_ms.train``)."""


def read(view):
    epochs = view.counts.get("epochs")
    if view.trace is None or not epochs:
        return None
    s = view.trace.span_seconds("trainer.fetch")
    return 1e3 * s / epochs if s > 0 else None
