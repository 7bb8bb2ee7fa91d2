"""Host milliseconds per round in the general avatar sweep (the port's
``daa.sweep.general`` spans: the cells' noise and grid, and their
``torch.func.vmap`` forwards of the whole model)."""


def read(view):
    rounds = view.counts.get("rounds")
    if view.trace is None or not rounds:
        return None
    s = view.trace.span_seconds("daa.sweep.general")
    return 1e3 * s / rounds if s > 0 else None
