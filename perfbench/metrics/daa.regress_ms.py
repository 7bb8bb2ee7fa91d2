"""Host milliseconds per round in the regressions (the port's
``daa.regress`` spans: each score's regression in
``compute_significativity``)."""


def read(view):
    rounds = view.counts.get("rounds")
    if view.trace is None or not rounds:
        return None
    s = view.trace.span_seconds("daa.regress")
    return 1e3 * s / rounds if s > 0 else None
