"""Host milliseconds per epoch in the test pass
(``train.trainer.test_one_epoch``, its metrics' fetch included)."""


def read(view):
    epochs = view.counts.get("epochs")
    if view.trace is None or not epochs:
        return None
    s = view.trace.span_seconds("train.trainer.test_one_epoch")
    return 1e3 * s / epochs if s > 0 else None
