"""The share of deep-A training's traced window in which no operation ran
on the card."""


def read(view):
    if view.trace is None or view.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - view.trace.busy_s / view.trace.window_s)
