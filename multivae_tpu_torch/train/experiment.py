"""The experiment: config, modalities, one model per ensemble member, the
train/test datasets and, for training, each member's train state.

Counterpart of ``multivae_tpu/train/experiment.py``. The datasets come from
the port's data layer (:mod:`multivae_tpu_torch.data`, numpy and pandas)
and are loaded on request (:meth:`MultimodalExperiment.set_datasets`).
Residualization is off, as in the JAX package's default
(``residualize_by`` is empty there). For
training, :meth:`MultimodalExperiment.set_optimizers` gives each member a
flat params buffer and an Adam state in the layout of the config's dims
(:func:`multivae_tpu_torch.params.dims_from`), on the experiment's device.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data import DataManager, MultimodalDataset, StandardScaler
from ..models import build_model, make_modalities
from ..params import dims_from
from .checkpoint import find_checkpoint, restore_checkpoint
from .config import Config
from .train_step import init_train_state, param_count


class MultimodalExperiment:
    def __init__(self, cfg: Config, device: torch.device | str):
        cfg.derive()
        self.cfg = cfg
        self.device = torch.device(device)
        self.modalities = make_modalities(cfg.input_dim, cfg.style_dim,
                                          cfg.likelihood)
        self.mod_names = list(self.modalities)
        # one model per ensemble member, seeded as the JAX package seeds
        # its members (cfg.seed + member index)
        self.models: List[torch.nn.Module] = [
            build_model(cfg, self.modalities, device, seed=cfg.seed + idx)
            for idx in range(cfg.num_models)]
        self.dataset_train = None
        self.dataset_test = None
        self.scalers = None
        self.params: List[torch.Tensor] = []
        self.opt_states: List = []
        # the trainer's: each member's splits on its device
        # (train.device_cohort) and test-pass graphs (trainer.EvalGraph)
        self.device_cohorts: Dict = {}
        self.test_graphs: Dict = {}

    # ---------------------------------------------------------- train state
    def set_optimizers(self):
        """Each member's flat params (from its model) and zero Adam state
        (``experiment.py:256-279``)."""
        dims = dims_from(self.cfg, self.cfg.batch_size)
        states = [init_train_state(m, dims) for m in self.models]
        self.params = [p for p, _ in states]
        self.opt_states = [o for _, o in states]
        print("num parameters: "
              + str(sum(param_count(m) for m in self.models)))

    # ------------------------------------------------------------ datasets
    def set_scalers(self, dataset):
        """A StandardScaler per modality, fit on the train samples where the
        modality is present (``experiment.py:146-166``)."""
        scalers = {}
        for mod in self.mod_names:
            idxs = [i for i in range(len(dataset))
                    if dataset._present[mod][dataset._true_idx(i)]]
            rows = dataset._row_idx[mod][
                dataset.indices[idxs] if dataset.indices is not None
                else np.asarray(idxs)]
            scaler = StandardScaler()
            scaler.fit(np.asarray(dataset.data[mod][rows], dtype=np.float64))
            scalers[mod] = scaler
        return scalers

    def set_datasets(self):
        """Train/test datasets per ensemble member, scaled on the fly by the
        member's train-fold scalers (``experiment.py:195-254``)."""
        cfg = self.cfg
        validation = None
        n_models = 1
        test_size = 0.2
        if cfg.num_models > 1:
            validation = cfg.num_models
            test_size = 0
            n_models = validation
        manager = DataManager(
            cfg.dataset, cfg.datasetdir, list(self.modalities),
            overwrite=True, allow_missing_blocks=cfg.allow_missing_blocks,
            validation=validation, test_size=test_size, seed=cfg.data_seed)
        fetcher = manager.fetcher

        train, test, scalers_all = [], [], []
        for model_idx in range(n_models):
            train_dataset = manager.train_dataset
            train_idx = test_idx = None
            test_input_path = fetcher.test_input_path
            test_metadata_path = fetcher.test_metadata_path
            if validation is not None:
                fold = train_dataset[model_idx]
                train_idx = fold["train_idx"]
                test_input_path = fetcher.train_input_path
                test_metadata_path = fetcher.train_metadata_path
                test_idx = fold["valid_idx"]
                train_dataset = fold["train"]
            scalers = self.set_scalers(train_dataset)
            scalers_all.append(scalers)
            train.append(MultimodalDataset(
                fetcher.train_input_path, fetcher.train_metadata_path,
                train_idx, on_the_fly_transform=scalers))
            test.append(MultimodalDataset(
                test_input_path, test_metadata_path, test_idx,
                on_the_fly_transform=scalers))
        if n_models == 1:
            train, test, scalers_all = train[0], test[0], scalers_all[0]
        self.dataset_train = train
        self.dataset_test = test
        self.scalers = scalers_all
        self.device_cohorts = {}

    def member_datasets(self, model_idx: int):
        """``(train, test)`` datasets of one ensemble member."""
        if self.cfg.num_models == 1:
            return self.dataset_train, self.dataset_test
        return self.dataset_train[model_idx], self.dataset_test[model_idx]

    # ------------------------------------------------------------- reload
    @classmethod
    def get_experiment(cls, flags_file: str, checkpoints_dir: str,
                       device: torch.device | str,
                       load_epoch: Optional[int] = None):
        """Rebuild a run's config and models from ``flags.json`` and the
        latest (or ``load_epoch``) checkpoint of every member; datasets are
        not loaded."""
        cfg = Config.load(flags_file)
        exp = cls(cfg, device)
        for model_idx in range(cfg.num_models):
            path, _ = find_checkpoint(checkpoints_dir, model_idx,
                                      cfg.num_models, load_epoch,
                                      cfg.model_save)
            print(path)
            restore_checkpoint(path, exp.models[model_idx])
        return exp, cfg


def load_run(outdir: str, run: str, device: torch.device | str,
             load_epoch: Optional[int] = None):
    """:meth:`MultimodalExperiment.get_experiment` of ``<outdir>/<run>``:
    the latest checkpoint, or the newest at or before ``load_epoch``."""
    expdir = os.path.join(outdir, run)
    flags_file = os.path.join(expdir, "flags.json")
    if not os.path.isfile(flags_file):
        raise ValueError("You need first to train the model.")
    return MultimodalExperiment.get_experiment(
        flags_file, os.path.join(expdir, "checkpoints"), device, load_epoch)


def load_trained(outdir: str, run: str, device: torch.device | str):
    """:func:`load_run` of the latest checkpoint with the datasets and
    their scalers loaded (``multivae_tpu/workflows.py:258 _load_trained``):
    ``(experiment, cfg)``."""
    experiment, cfg = load_run(outdir, run, device)
    experiment.set_datasets()
    return experiment, cfg
