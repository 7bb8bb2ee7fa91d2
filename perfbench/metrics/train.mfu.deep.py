"""Deep-A training's window of model FLOPs over the device's busy time in
the trace and the float32 peak of one H100 SXM (``perfbench/counts.py``),
as ``train.mfu`` reads the flagship's."""

from perfbench.counts import PEAK_F32_FLOPS


def read(view):
    epochs = view.counts.get("epochs")
    if view.trace is None or not epochs or view.trace.busy_s <= 0:
        return None
    flops = view.counts["model_flops_per_epoch"] * epochs
    return 100.0 * flops / view.trace.busy_s / PEAK_F32_FLOPS
