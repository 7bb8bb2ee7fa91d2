"""Host milliseconds per epoch in the autograd general steps (the port's
``trainer.general_step`` spans: each step call of ``run_general``, torch
autograd's forward and backward and the flat Adam, inside its
``trainer.launch``)."""


def read(view):
    epochs = view.counts.get("epochs")
    if view.trace is None or not epochs:
        return None
    s = view.trace.span_seconds("trainer.general_step")
    return 1e3 * s / epochs if s > 0 else None
