"""Host milliseconds per round in the regression and vote stage
(``analysis.daa.compute_significativity`` with ``analysis.stats``)."""


def read(view):
    rounds = view.counts.get("rounds")
    if view.trace is None or not rounds:
        return None
    s = view.trace.span_seconds("analysis.daa.compute_significativity")
    return 1e3 * s / rounds if s > 0 else None
