"""The avatar-sweep kernel's share of its roofline: the least time of the
rounds' sweeps (``perfbench/counts.py``) over its device time in the
traced window."""


def read(view):
    if view.trace is None:
        return None
    device = view.trace.kernel_seconds(("avatar_sweep_kernel",))
    if device <= 0:
        return None
    bound = view.counts["sweep_kernel_bound_s"] * view.counts["rounds"]
    return 100.0 * bound / device
