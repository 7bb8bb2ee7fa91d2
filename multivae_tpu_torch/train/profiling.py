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

Spans and counters. :func:`span` marks a stretch of host work by name: a
``torch.profiler.record_function`` while a profiler session is open, so it
lands in the Chrome trace (``cat: user_annotation``) on the profiler's
clock beside the device records, and one shared null context otherwise.
:func:`count` adds to :data:`COUNTS` (always on); :func:`to_device`,
:func:`fetch` and :func:`fetch_into` (a fetch into a host array the caller
holds) copy and count the bytes (``h2d_bytes``, ``d2h_bytes``), a fetch in
a span of its own. A :func:`trace` block keeps the window's
counts, :func:`last_counts`: each of :data:`COUNTS`, and each ops module's
kernel launches and steps (:func:`kernel_counters`) as
``launches.<kernel>`` / ``steps.<kernel>``, as differences of the counters
between the block's start and end.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import os
from typing import Dict

import numpy as np
import torch


def trace_path(profile_dir: str, epoch: int) -> str:
    """The Chrome trace of ``epoch`` under ``profile_dir``."""
    return os.path.join(profile_dir, f"epoch_{epoch:04d}.pt.trace.json")


WARM_UP_LAUNCHES = 256  # throwaway kernels at the window's start on a card
WARM_UP_KERNEL = "spin_kernel"  # their name in the trace

_NULL_SPAN = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def span(name: str):
    """A span of host work named ``name``: a ``record_function`` while a
    profiler session is open, else the one shared null context."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL_SPAN


def spanned(name: str):
    """Decorate a function so that each call runs in :func:`span`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


COUNTS: Dict[str, int] = {}  # the port's own counters, for the process


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name``."""
    COUNTS[name] = COUNTS.get(name, 0) + int(n)


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` (on the host) copied to ``device``, its bytes counted as
    ``h2d_bytes`` (on the CPU too, where the copy is none)."""
    count("h2d_bytes", t.nbytes)
    return t.to(device)


def fetch(t: torch.Tensor, name: str) -> torch.Tensor:
    """``t`` fetched to the host in the span ``name`` (the fetch waits for
    the work launched before it), its bytes counted as ``d2h_bytes``."""
    with span(name):
        host = t.cpu()
    count("d2h_bytes", host.nbytes)
    return host


def fetch_into(t: torch.Tensor, out: np.ndarray, name: str) -> None:
    """:func:`fetch` into the writable host array ``out`` of ``t``'s shape
    and dtype (a slot of a larger array, say), in the span ``name``."""
    dst = torch.from_numpy(out)
    if dst.shape != t.shape or dst.dtype != t.dtype:
        raise ValueError(f"cannot fetch a {t.dtype} {tuple(t.shape)} tensor "
                         f"into a {dst.dtype} {tuple(dst.shape)} array")
    with span(name):
        dst.copy_(t)
    count("d2h_bytes", dst.nbytes)


# the ops modules that count their kernels' launches (KERNEL_LAUNCHES) and
# the train steps those launches ran (KERNEL_STEPS)
KERNEL_COUNTER_MODULES = ("adam", "fused_daa", "fused_generic",
                          "fused_methods", "fused_presence", "fused_step")
_KERNEL_COUNTER_KINDS = {"launches": "KERNEL_LAUNCHES",
                         "steps": "KERNEL_STEPS"}


def kernel_counters(kind: str) -> Dict[str, Dict[str, int]]:
    """Each kernel's ``kind`` counter (``"launches"`` or ``"steps"``) by
    kernel name: the ops module's own dict that holds it, to read or reset
    in place."""
    attr = _KERNEL_COUNTER_KINDS[kind]
    out = {}
    for name in KERNEL_COUNTER_MODULES:
        counters = getattr(importlib.import_module(
            f"..ops.{name}", __package__), attr, {})
        out.update(dict.fromkeys(counters, counters))
    return out


def _all_counts() -> Dict[str, int]:
    out = dict(COUNTS)
    for kind in _KERNEL_COUNTER_KINDS:
        for kernel, counters in kernel_counters(kind).items():
            out[f"{kind}.{kernel}"] = counters[kernel]
    return out


_LAST_COUNTS: Dict[str, int] = {}


def last_counts() -> Dict[str, int]:
    """The counts of the last :func:`trace` block that ended: each counter's
    growth over the block."""
    return dict(_LAST_COUNTS)


@contextlib.contextmanager
def trace(profile_dir: str, device, epoch: int = 0):
    """Profile the block on ``device`` (on a card: after the device's
    earlier work and the warm-up, and ending in a synchronize), keep its
    counts (:func:`last_counts`) and write its Chrome trace to
    :func:`trace_path`; yields the ``torch.profiler.profile``."""
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
        before = _all_counts()
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        after = _all_counts()
        _LAST_COUNTS.clear()
        _LAST_COUNTS.update({k: v - before.get(k, 0)
                             for k, v in after.items()})
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
