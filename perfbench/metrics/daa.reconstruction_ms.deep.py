"""Host milliseconds per round in the reconstruction (the port's
``daa.reconstruction`` spans: each round's ``reconstruction_stats`` call,
on deep-A the ``M`` Monte-Carlo passes)."""


def read(view):
    rounds = view.counts.get("rounds")
    if view.trace is None or not rounds:
        return None
    s = view.trace.span_seconds("daa.reconstruction")
    return 1e3 * s / rounds if s > 0 else None
