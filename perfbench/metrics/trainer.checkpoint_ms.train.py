"""Host milliseconds per epoch in checkpoints, amortised over the window's
epochs (the union of the port's ``trainer.checkpoint.serialize`` spans,
the state's fetch (``trainer.checkpoint.fetch``) and npz encoding, and ``trainer.checkpoint.write``
spans, each file's write, fsyncs and rename)."""

NAMES = ("trainer.checkpoint.serialize", "trainer.checkpoint.write")


def read(view):
    epochs = view.counts.get("epochs")
    if view.trace is None or not epochs:
        return None
    s = view.trace._union([(a, b) for a, b, n in view.trace.spans
                           if n in NAMES]) / 1e6
    return 1e3 * s / epochs if s > 0 else None
