"""Tracing an epoch: the counterpart of the JAX package's
``jax.profiler.start_trace`` / ``stop_trace`` around the first trained epoch
(``multivae_tpu/train/trainer.py:966-986, 1075-1086``).

:func:`trace` runs ``torch.profiler.profile`` over a block, with CPU
activity and, when the device is a card, CUDA activity, and writes a
Chrome trace under the profile directory; :func:`device_ms_by_name` sums a
profile's device time by event name (the kernels' names on a card).

On a card the window opens with a warm-up: :data:`WARM_UP_LAUNCHES`
throwaway spin kernels (``torch.cuda._sleep``, whose kernel is named
``spin_kernel``), finished before the block runs. A session of
``torch.profiler`` in a process that has already run a great deal on the
card loses its first device records, more of them as the process goes on
(seen on an H100: from none to a dozen kernels and more a session); the warm-up's
kernels are lost in place of the block's. :func:`device_ms_by_name` leaves
them out; :func:`warm_up_kept` counts those the trace kept.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict

import torch


def trace_path(profile_dir: str, epoch: int) -> str:
    """The Chrome trace of ``epoch`` under ``profile_dir``."""
    return os.path.join(profile_dir, f"epoch_{epoch:04d}.pt.trace.json")


WARM_UP_LAUNCHES = 256  # throwaway kernels at the window's start on a card
WARM_UP_KERNEL = "spin_kernel"  # their name in the trace


@contextlib.contextmanager
def trace(profile_dir: str, device, epoch: int = 0):
    """Profile the block on ``device`` (on a card: after the device's
    earlier work and the warm-up, and ending in a synchronize) and write
    its Chrome trace to :func:`trace_path`; yields the
    ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        if device.type == "cuda":
            with torch.cuda.device(device):
                for _ in range(WARM_UP_LAUNCHES):
                    torch.cuda._sleep(1000)
            torch.cuda.synchronize(device)
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(trace_path(profile_dir, epoch))


def device_ms_by_name(prof) -> Dict[str, float]:
    """Each event name's self device time in ms, for the names that have
    any, the tracer's warm-up left out."""
    out = {}
    for ev in prof.key_averages():
        if WARM_UP_KERNEL in ev.key:
            continue
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if t > 0:
            out[ev.key] = t / 1e3
    return out


def warm_up_kept(prof) -> int:
    """How many of the warm-up's kernels the profile kept (fewer than
    :data:`WARM_UP_LAUNCHES`: the session lost its first device records)."""
    return sum(ev.count for ev in prof.key_averages()
               if WARM_UP_KERNEL in ev.key)
