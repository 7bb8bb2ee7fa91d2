"""Host milliseconds per round in fetches from the card (the port's
``daa.fetch`` spans: the reconstruction, the sufficient statistics and the
scores, each waiting for the work launched before it)."""


def read(view):
    rounds = view.counts.get("rounds")
    if view.trace is None or not rounds:
        return None
    s = view.trace.span_seconds("daa.fetch")
    return 1e3 * s / rounds if s > 0 else None
