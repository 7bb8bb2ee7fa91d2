"""The hand-written step kernels' share of their roofline: the least time
of the steps they took (``perfbench/counts.py``, per epoch) over their
device time in the traced window."""

STEP_KERNELS = ("mopoe_steps_kernel", "presence_steps_kernel",
                "method_steps_kernel", "generic_steps_kernel")


def read(view):
    if view.trace is None:
        return None
    device = view.trace.kernel_seconds(STEP_KERNELS)
    if device <= 0:
        return None
    bound = view.counts["step_kernel_bound_s_per_epoch"] * view.counts[
        "epochs"]
    return 100.0 * bound / device
