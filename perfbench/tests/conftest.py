"""Shared pieces of the benchmark's tests: the ``card`` marker (tests that
need a CUDA card skip without one, decided in a fixture) and a small
size of every configuration for runs on the CPU."""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a size a CPU test run holds: every width cut, the cohort and the DAA
# grid small
TINY = {"input_dim": [3, 12], "style_dim": [2, 3], "class_dim": 4,
        "hidden_dim": 16, "batch_size": 64, "n_subjects": 300,
        "n_scores": 3, "n_rois": 12, "daa_n_samples": 10,
        "daa_n_subjects": 8, "daa_M": 4, "daa_n_validation": 2,
        "daa_warmup_rounds": 1, "train_warmup_epochs": 2}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark measures only on one")
    return torch.device("cuda:0")


def run_tiny(workload: str, seconds: float = 0.5, trace: bool = False,
             overrides=None):
    """One run of ``workload`` on the CPU at :data:`TINY` size:
    ``(result, compared, host)``."""
    from perfbench import harness

    cfg = dict(TINY, **(overrides or {}))
    return harness.run_cell(ROOT, workload, 20241018, seconds, trace, "cpu",
                            time.perf_counter(), 1, cfg)
