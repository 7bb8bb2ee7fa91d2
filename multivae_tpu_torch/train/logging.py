"""Metric logging: tensorboard scalars + a CSV mirror.

A copy of ``multivae_tpu/train/logging.py`` (numpy; tensorboardX only
where it imports): the same ``metrics.csv``, scalar families and resume-step
logic.

Scalar families follow the reference's TBLogger
(``experiments/utils/TBLogger.py:84-101``): per-step ``train/Loss``,
``train/LogProb``, ``train/KLD``, ``train/group_divergence``, latent mu/logvar
means, plus ``Likelihoods/*`` and ``PRD`` eval families. A CSV mirror
(``metrics.csv``) is written so runs remain inspectable without tensorboard.
"""

from __future__ import annotations

import csv
import os
from typing import Dict

import numpy as np

try:
    from tensorboardX import SummaryWriter
except Exception:  # pragma: no cover
    SummaryWriter = None


class MetricLogger:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.writer = None
        if use_tensorboard and SummaryWriter is not None:
            self.writer = SummaryWriter(log_dir)
        self._csv_path = os.path.join(log_dir, "metrics.csv")
        # on resume, continue the step axis where the previous session
        # stopped — steps are monotone within a session, so the last CSV
        # row carries the previous maximum (a fresh counter would
        # interleave resumed rows below the old ones in TB and the CSV)
        self.step = self._resume_step(self._csv_path)
        self._csv_file = open(self._csv_path, "a", newline="")
        self._csv = csv.writer(self._csv_file)
        if os.path.getsize(self._csv_path) == 0:
            self._csv.writerow(["step", "phase", "metric", "value"])

    @staticmethod
    def _resume_step(csv_path: str) -> int:
        try:
            if not os.path.isfile(csv_path):
                return 0
            with open(csv_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - 4096))
                raw = f.read()
            # a session killed mid-write leaves a torn final line ('12' of
            # step '123' still parses as an int) — only a line terminated by
            # the newline the writer emits AND splitting into the 4 expected
            # fields counts; otherwise fall back to the previous complete one
            if not raw.endswith(b"\n"):
                raw = raw[: raw.rfind(b"\n") + 1] if b"\n" in raw else b""
            for ln in reversed(raw.split(b"\n")):
                ln = ln.strip()
                if not ln:
                    continue
                fields = ln.split(b",")
                if len(fields) != 4:
                    continue
                try:
                    return int(fields[0]) + 1
                except ValueError:
                    continue  # header row
            return 0
        except OSError:
            return 0

    def add_text(self, tag: str, text: str) -> None:
        if self.writer is not None:
            self.writer.add_text(tag, text, 0)

    def _scalar(self, phase: str, name: str, value) -> None:
        value = float(np.asarray(value))
        if self.writer is not None:
            self.writer.add_scalar(f"{phase}/{name}", value, self.step)
        self._csv.writerow([self.step, phase, name, value])

    def write_metrics(self, phase: str, metrics: Dict[str, object]) -> None:
        """Log one step's metric dict (keys like ``loss``, ``log_prob/m``,
        ``kld/subset``, ``joint_divergence``)."""
        for name, value in metrics.items():
            self._scalar(phase, name, value)
        self.step += 1

    def write_training_logs(self, metrics) -> None:
        self.write_metrics("train", metrics)

    def write_testing_logs(self, metrics) -> None:
        self.write_metrics("test", metrics)

    def write_lhood_logs(self, lhoods: Dict[str, Dict[str, float]]) -> None:
        for s_key in sorted(lhoods):
            for m_key, val in lhoods[s_key].items():
                self._scalar("Likelihoods", f"{s_key}/{m_key}", val)

    def write_prd_scores(self, prd: Dict[str, float]) -> None:
        for key, val in prd.items():
            self._scalar("PRD", key, val)

    def write_lr_eval(self, lr_eval: Dict[str, float]) -> None:
        """Latent-probe accuracies per subset (the reference's
        ``Latent Representation/*`` family, ``TBLogger.py:40-44``)."""
        for l_key in sorted(lr_eval):
            self._scalar("Latent Representation", l_key, lr_eval[l_key])

    def write_coherence_logs(self, gen_eval: Dict[str, object]) -> None:
        """Conditional/random generation coherence (the reference's
        ``Generation/*`` family, ``TBLogger.py:47-57``). ``gen_eval``:
        ``{"cond": {subset: {modality: acc}}, "random": float}``."""
        for l_key in sorted(gen_eval.get("cond", {})):
            for m_key, val in gen_eval["cond"][l_key].items():
                self._scalar("Generation", f"{l_key}/{m_key}", val)
        if "random" in gen_eval:
            self._scalar("Generation", "Random", gen_eval["random"])

    def flush(self) -> None:
        self._csv_file.flush()
        if self.writer is not None:
            self.writer.flush()

    def close(self) -> None:
        self.flush()
        self._csv_file.close()
        if self.writer is not None:
            self.writer.close()
