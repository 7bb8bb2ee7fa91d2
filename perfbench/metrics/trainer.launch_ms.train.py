"""Host milliseconds per epoch in drawing the noise and launching the
steps (the union of the port's ``trainer.noise`` spans, the CPU draw and
its one copy, and ``trainer.launch`` spans, each kernel group's stacking,
copies and launch or autograd step)."""

NAMES = ("trainer.noise", "trainer.launch")


def read(view):
    epochs = view.counts.get("epochs")
    if view.trace is None or not epochs:
        return None
    s = view.trace._union([(a, b) for a, b, n in view.trace.spans
                           if n in NAMES]) / 1e6
    return 1e3 * s / epochs if s > 0 else None
