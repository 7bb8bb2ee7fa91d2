"""The port's tracer (``multivae_tpu_torch/train/profiling.py``) on the CPU:
the trace it writes, and its summaries of a profile, which leave out the
warm-up kernels it launches at a card's window start."""

import json
from types import SimpleNamespace

import torch

from multivae_tpu_torch.train import profiling


class _Profile:
    """A stand-in for ``torch.profiler.profile``: ``key_averages`` only."""

    def __init__(self, rows):
        self.rows = [SimpleNamespace(key=k, count=n,
                                     self_device_time_total=us)
                     for k, n, us in rows]

    def key_averages(self):
        return self.rows


WARM_UP = f"at::cuda::(anonymous namespace)::{profiling.WARM_UP_KERNEL}(long)"
ROWS = [(WARM_UP, 11, 7.0),
        ("void (anonymous namespace)::mopoe_steps_kernel<false>", 2, 353.0),
        ("Memcpy HtoD (Pageable -> Device)", 5, 40.0),
        ("aten::add_", 3, 0.0)]


def test_trace_on_cpu_writes_a_chrome_trace_of_the_block(tmp_path):
    with profiling.trace(str(tmp_path), "cpu", 3) as prof:
        torch.ones(8, 8).matmul(torch.ones(8, 8))
    path = profiling.trace_path(str(tmp_path), 3)
    assert path.endswith("epoch_0003.pt.trace.json")
    with open(path) as fh:
        names = {ev.get("name") for ev in json.load(fh)["traceEvents"]}
    assert "aten::matmul" in names
    # no warm-up on the CPU
    assert profiling.warm_up_kept(prof) == 0


def test_device_ms_by_name_leaves_out_the_warm_up_and_idle_names():
    # exact: the sums are the rows' own numbers over 1e3
    assert profiling.device_ms_by_name(_Profile(ROWS)) == {
        "void (anonymous namespace)::mopoe_steps_kernel<false>": 0.353,
        "Memcpy HtoD (Pageable -> Device)": 0.04}


def test_warm_up_kept_counts_the_warm_up_kernels_only():
    assert profiling.warm_up_kept(_Profile(ROWS)) == 11
    assert profiling.warm_up_kept(_Profile(ROWS[1:])) == 0
