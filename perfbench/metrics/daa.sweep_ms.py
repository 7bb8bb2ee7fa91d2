"""Device milliseconds per round of the work launched inside the avatar
sweep (``analysis.daa.avatar_sweep``: the sweep kernel, or the general
sweep's forwards)."""


def read(view):
    rounds = view.counts.get("rounds")
    if view.trace is None or not rounds:
        return None
    s = view.trace.device_seconds_in("analysis.daa.avatar_sweep")
    return 1e3 * s / rounds if s > 0 else None
