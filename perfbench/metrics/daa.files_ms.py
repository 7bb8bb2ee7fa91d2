"""Host milliseconds per round saving and loading the DAA's files (the
union of the port's ``daa.files.save`` and ``daa.files.load`` spans in
``run_daa`` and ``compute_significativity``)."""

NAMES = ("daa.files.save", "daa.files.load")


def read(view):
    rounds = view.counts.get("rounds")
    if view.trace is None or not rounds:
        return None
    s = view.trace._union([(a, b) for a, b, n in view.trace.spans
                           if n in NAMES]) / 1e6
    return 1e3 * s / rounds if s > 0 else None
