"""Run-directory layout.

A copy of ``multivae_tpu/utils/filehandling.py``.

Mirrors ``experiments/utils/filehandling.py:13-94``: run id is
``<dataset>_<YYYY_MM_DD_HH_MM>``; the run dir gets ``checkpoints/``, ``logs/``
(one per ensemble member), ``logs_clf/``, ``generation_evaluation/``,
``inference/``, ``fid/`` and ``plots/{swapping,random_samples,cond_gen}``.
"""

from __future__ import annotations

import os
import shutil
from datetime import datetime


def create_dir(dir_name: str) -> None:
    if os.path.exists(dir_name):
        shutil.rmtree(dir_name, ignore_errors=True)
    os.makedirs(dir_name)


def get_str_experiments(cfg) -> str:
    date_str = datetime.now().strftime("%Y_%m_%d_%H_%M")
    return f"{cfg.dataset}_{date_str}"


def create_dir_structure(cfg, train: bool = True):
    """Populate the run-dir fields of ``cfg`` and create the directories."""
    if train:
        cfg.str_experiment = get_str_experiments(cfg)
        cfg.dir_experiment_run = os.path.join(cfg.dir_experiment,
                                              cfg.str_experiment)
        os.makedirs(cfg.dir_experiment, exist_ok=True)
        create_dir(cfg.dir_experiment_run)
    else:
        cfg.dir_experiment_run = cfg.dir_experiment

    cfg.dir_checkpoints = os.path.join(cfg.dir_experiment_run, "checkpoints")
    cfg.dir_logs = os.path.join(cfg.dir_experiment_run, "logs")
    if train:
        create_dir(cfg.dir_checkpoints)
        if cfg.num_models > 1:
            for model_idx in range(cfg.num_models):
                create_dir(os.path.join(cfg.dir_logs, f"model_{model_idx}"))
        else:
            create_dir(cfg.dir_logs)
        for sub in ("logs_clf", "generation_evaluation", "inference", "fid",
                    "plots", os.path.join("plots", "swapping"),
                    os.path.join("plots", "random_samples"),
                    os.path.join("plots", "cond_gen")):
            create_dir(os.path.join(cfg.dir_experiment_run, sub))
    return cfg


def model_log_dir(cfg, model_idx: int) -> str:
    if cfg.num_models > 1:
        return os.path.join(cfg.dir_logs, f"model_{model_idx}")
    return cfg.dir_logs


def model_checkpoint_dir(cfg, model_idx: int, epoch: int) -> str:
    """``checkpoints/[model_i/]<epoch:04d>`` (``run_epochs.py:243-250``)."""
    base = cfg.dir_checkpoints
    if cfg.num_models > 1:
        base = os.path.join(base, f"model_{model_idx}")
    return os.path.join(base, str(epoch).zfill(4))
