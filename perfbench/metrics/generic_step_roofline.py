"""The layer-stack step kernel's share of its roofline: the least time of
the steps it took (``perfbench/counts.py``, per epoch: the full complete
batches off the split layout) over the device time of
``generic_steps_kernel`` in the traced window."""


def read(view):
    epochs = view.counts.get("epochs")
    if view.trace is None or not epochs:
        return None
    device = view.trace.kernel_seconds(("generic_steps_kernel",))
    if device <= 0:
        return None
    bound = view.counts["step_kernel_bound_s_per_epoch"] * epochs
    return 100.0 * bound / device
