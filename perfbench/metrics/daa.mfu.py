"""The window's rounds' model FLOPs (reconstruction and sweep) over the
device's busy time in the trace and the float32 peak of one H100 SXM
(``perfbench/counts.py``). Busy time, not the wall: the traced run's wall
carries the profiler's and the spans' cost on the host, and the device's
is what a peak bounds."""

from perfbench.counts import PEAK_F32_FLOPS


def read(view):
    rounds = view.counts.get("rounds")
    if view.trace is None or not rounds or view.trace.busy_s <= 0:
        return None
    return 100.0 * rounds * view.counts["round_flops"] / view.trace.busy_s \
        / PEAK_F32_FLOPS
