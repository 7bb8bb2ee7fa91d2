"""Experiment configuration: the ``flags.json`` schema.

A copy of ``multivae_tpu/train/config.py`` (which imports no JAX), kept in
the port so that loading a run needs nothing of the JAX package: the same
typed dataclass, the same derived fields (:meth:`Config.derive`) and the
same JSON file, so either package reads the other's runs. Of the JAX
package's parallelism and TPU-training knobs the port reads
``data_parallel``, ``ensemble_parallel``, ``fused_training`` (and refuses
``tensor_parallel > 1`` and a ``precision`` other than float32); the others
are carried for that compatibility and read by nothing here.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

METHODS = ("poe", "moe", "jsd", "joint_elbo")


@dataclass
class Config:
    """The run's flags; each field means what it means in
    ``multivae_tpu/train/config.py``."""

    # experiment identity / IO
    dataset: str = "synthetic"
    datasetdir: str = ""
    dir_experiment: str = "/tmp/multivae_tpu"
    str_experiment: str = ""
    dir_experiment_run: str = ""
    dir_checkpoints: str = ""
    dir_logs: str = ""
    model_save: str = "model"
    save_optimizer: str = "all"     # all | latest | none

    # model
    method: str = "joint_elbo"
    input_dim: List[int] = field(default_factory=lambda: [7, 444])
    class_dim: int = 20
    style_dim: List[int] = field(default_factory=lambda: [3, 20])
    factorized_representation: bool = True
    likelihood: str = "normal"
    num_hidden_layer_encoder: int = 1
    num_hidden_layer_decoder: int = 0
    hidden_dim: int = 256  # reference hardcodes 256 (networks.py:14)
    dropout_rate: float = 0.0
    initial_out_logvar: float = -3.0
    learn_output_scale: bool = True
    learn_output_sample_scale: bool = False
    include_prior_expert: bool = False   # reference-surface no-op

    # training
    num_models: int = 1
    batch_size: int = 256
    initial_learning_rate: float = 0.002
    beta_1: float = 0.9
    beta_2: float = 0.999
    start_epoch: int = 0
    end_epoch: int = 100
    beta: float = 1.0
    beta_style: float = 1.0
    beta_content: float = 1.0
    kl_annealing: int = 0                # reference-surface no-op
    poe_unimodal_elbos: bool = True
    grad_scaling: bool = False           # reference-surface no-op
    seed: int = 42

    # data
    allow_missing_blocks: bool = True
    data_multiplications: int = 1        # reference-surface no-op
    data_seed: object = "defaults"
    subsampled_reconstruction: bool = True   # reference-surface no-op

    # evaluation
    calc_nll: bool = False
    calc_prd: bool = False
    calc_clf: bool = False
    calc_coherence: bool = False
    eval_freq: int = 25
    eval_freq_fid: int = 100
    num_samples_fid: int = 10000
    num_training_samples_lr: int = 500
    save_figure: bool = False
    load_saved: bool = False

    # the JAX package's parallelism and TPU-training knobs
    data_parallel: int = 1
    tensor_parallel: int = 1
    ensemble_parallel: object = "auto"
    precision: str = "float32"
    donate_buffers: bool = True
    fused_training: bool = True
    epoch_chunk: int = 50

    # derived (filled by derive())
    num_mods: int = 0
    modality_poe: bool = False
    modality_moe: bool = False
    modality_jsd: bool = False
    joint_elbo: bool = False
    div_weight: Optional[float] = None
    div_weight_uniform_content: Optional[float] = None
    alpha_modalities: List[float] = field(default_factory=list)

    def derive(self) -> "Config":
        """Fill derived fields; mirrors ``workflow.py:125-145``."""
        if self.method not in METHODS:
            raise ValueError(f"Method not implemented: {self.method}")
        if self.save_optimizer not in ("all", "latest", "none"):
            raise ValueError(
                f"save_optimizer must be all|latest|none, "
                f"got: {self.save_optimizer}")
        self.modality_poe = self.method == "poe"
        self.modality_moe = self.method == "moe"
        self.modality_jsd = self.method == "jsd"
        self.joint_elbo = self.method == "joint_elbo"
        if self.modality_poe:
            self.poe_unimodal_elbos = True
        self.num_mods = len(self.input_dim)
        if isinstance(self.style_dim, int):
            self.style_dim = [self.style_dim] * self.num_mods
        elif len(self.style_dim) != self.num_mods:
            self.style_dim = [self.style_dim[0]] * self.num_mods
        if not self.factorized_representation:
            self.style_dim = [0] * len(self.style_dim)
        if self.div_weight_uniform_content is None:
            self.div_weight_uniform_content = 1.0 / (self.num_mods + 1)
        if self.div_weight is None:
            self.div_weight = 1.0 / (self.num_mods + 1)
        self.alpha_modalities = [self.div_weight_uniform_content] + [
            self.div_weight for _ in range(self.num_mods)]
        if isinstance(self.ensemble_parallel, str):
            val = self.ensemble_parallel.lower()
            if val in ("true", "1", "yes"):
                self.ensemble_parallel = True
            elif val in ("false", "0", "no"):
                self.ensemble_parallel = False
            else:
                self.ensemble_parallel = "auto"
        return self

    # ---- persistence (reference: flags.rar via torch.save;
    #      utils/utils.py:115-125) ----
    def save(self, path: str) -> None:
        payload = dataclasses.asdict(self)
        with open(path, "w") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as fh:
            payload = json.load(fh)
        known = {f.name for f in dataclasses.fields(cls)}
        cfg = cls(**{k: v for k, v in payload.items() if k in known})
        return cfg.derive()

    @classmethod
    def flags_path(cls, run_dir: str) -> str:
        return os.path.join(run_dir, "flags.json")

    def describe(self) -> str:
        return "\n".join(f"{k}: {v}" for k, v in
                         sorted(dataclasses.asdict(self).items()))
