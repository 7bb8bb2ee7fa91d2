"""The window's rounds' model FLOPs over the device's busy time in the
trace and the float32 peak of one H100 SXM, as ``daa.mfu``: on deep-A a
round's FLOPs are those of the ``M``-pass reconstruction and the whole
sweep (``perfbench/counts.py`` ``daa_round_flops(cfg, closed_form=False)``,
whatever implements them)."""

from perfbench.counts import PEAK_F32_FLOPS


def read(view):
    rounds = view.counts.get("rounds")
    if view.trace is None or not rounds or view.trace.busy_s <= 0:
        return None
    return 100.0 * rounds * view.counts["round_flops"] / view.trace.busy_s \
        / PEAK_F32_FLOPS
