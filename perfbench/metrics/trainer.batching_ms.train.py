"""Host milliseconds per epoch in the trainer's batching
(``train.trainer.epoch_batches``: the sampler and the gather)."""


def read(view):
    epochs = view.counts.get("epochs")
    if view.trace is None or not epochs:
        return None
    s = view.trace.span_seconds("train.trainer.epoch_batches")
    return 1e3 * s / epochs if s > 0 else None
