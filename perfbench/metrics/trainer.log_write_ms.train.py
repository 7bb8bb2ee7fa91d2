"""Host milliseconds per epoch writing the metrics' rows (the port's
``trainer.log_rows`` spans: ``metrics.csv`` through ``MetricLogger``)."""


def read(view):
    epochs = view.counts.get("epochs")
    if view.trace is None or not epochs:
        return None
    s = view.trace.span_seconds("trainer.log_rows")
    return 1e3 * s / epochs if s > 0 else None
