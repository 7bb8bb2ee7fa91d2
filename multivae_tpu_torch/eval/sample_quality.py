"""Sample-quality metrics: FID and PRD over decoded feature vectors.

Counterpart of ``multivae_tpu/eval/sample_quality.py``. The cohorts are
tabular (7-d clinical + 444-d ROI vectors), so the feature vectors are the
embeddings: conditional generations per modality subset are compared with
the real test data. The Frechet distance is scipy's ``linalg.sqrtm`` form of
``fid/fid_score.py:calculate_frechet_distance``; the PRD is
:mod:`multivae_tpu_torch.eval.prd`.

Noise: generation runs on the model's device with draws made on the CPU
and copied there. :func:`generate_conditional_samples` draws from a CPU
generator seeded ``cfg.seed + 7`` (the style draws, then one content draw
per subset: ``MultimodalVAE.cond_generation``'s order),
:func:`generate_random_samples` from one seeded ``cfg.seed + 13`` (the
content draw, then the styles: ``MultimodalVAE.generate``'s order). Either
takes a ``generator`` of its own instead. No JAX stream is reproduced.
"""

from __future__ import annotations

import importlib
import os
from typing import Dict, Optional

import numpy as np
import torch
from scipy import linalg

from .prd import compute_prd_from_embedding, prd_to_max_f_beta_pair


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2,
                               eps: float = 1e-6) -> float:
    """Frechet distance between two Gaussians."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def embedding_stats(x: np.ndarray):
    x = np.asarray(x, dtype=np.float64)
    return x.mean(axis=0), np.cov(x, rowvar=False)


def load_embedding(spec):
    """Resolve an embedding spec to ``samples [N, D] -> features [N, E]``:

    * ``None`` — identity (the feature vectors are the embeddings);
    * a callable — used as is;
    * ``"<path>.npz"`` — the affine map ``x @ W (+ b)`` of its arrays ``W``
      (``[D, E]``) and optional ``b`` (``[E]``);
    * ``"module:attr"`` — an imported callable.
    """
    if spec is None or callable(spec):
        return spec
    if isinstance(spec, str) and spec.endswith(".npz"):
        with np.load(spec) as z:
            w = np.asarray(z["W"], dtype=np.float64)
            b = np.asarray(z["b"], dtype=np.float64) if "b" in z else None

        def affine(x):
            out = np.asarray(x, dtype=np.float64) @ w
            return out + b if b is not None else out

        return affine
    if isinstance(spec, str) and ":" in spec:
        mod_name, attr = spec.split(":", 1)
        fn = getattr(importlib.import_module(mod_name), attr)
        if not callable(fn):
            raise TypeError(f"embedding {spec!r} is not callable")
        return fn
    raise ValueError(
        f"embedding spec {spec!r}: expected None, a callable, a .npz path "
        "(arrays 'W'/'b') or 'module:attr'")


def _embed(x, embedding):
    return np.asarray(embedding(x)) if embedding is not None else x


def calculate_fid_from_embeddings(eval_data: np.ndarray,
                                  ref_data: np.ndarray,
                                  embedding=None) -> float:
    embedding = load_embedding(embedding)
    mu1, s1 = embedding_stats(_embed(eval_data, embedding))
    mu2, s2 = embedding_stats(_embed(ref_data, embedding))
    return calculate_frechet_distance(mu1, s1, mu2, s2)


def _load_sample_dump(path: str) -> np.ndarray:
    """One stacked ``.npy`` array, or a directory of per-sample ``.npy``
    vectors (:func:`save_generated_samples`'s layout)."""
    if os.path.isdir(path):
        files = sorted(f for f in os.listdir(path) if f.endswith(".npy"))
        return np.stack([np.load(os.path.join(path, f)) for f in files])
    return np.load(path)


def calculate_fid_given_paths(path_eval: str, path_ref: str,
                              embedding=None) -> float:
    """FID between two sample dumps (stacked ``.npy`` files or per-sample
    dump directories), through ``embedding`` first."""
    return calculate_fid_from_embeddings(_load_sample_dump(path_eval),
                                         _load_sample_dump(path_ref),
                                         embedding=embedding)


def save_generated_samples(exp, model_idx: int = 0,
                           num_samples: Optional[int] = None) -> str:
    """Per-group per-modality sample dumps, one ``.npy`` vector per sample
    under ``<run>/fid[/model_<i>]/<group>/<modality>/NNNNNN.npy``; groups
    ``real``, ``random`` and one per conditioning subset, at most
    ``num_samples`` (default ``cfg.num_samples_fid``) rows each. Returns
    the dump root."""
    cfg = exp.cfg
    if num_samples is None:
        num_samples = int(getattr(cfg, "num_samples_fid", 10000))
    gen, real = generate_conditional_samples(exp, model_idx)
    n_real = len(next(iter(real.values())))
    rand = generate_random_samples(exp, model_idx,
                                   num_samples=min(num_samples, n_real))
    groups = {"real": real, "random": rand, **gen}
    base = os.path.join(cfg.dir_experiment_run, "fid")
    if cfg.num_models > 1:
        base = os.path.join(base, f"model_{model_idx}")
    for group, mods in groups.items():
        for m_key, arr in mods.items():
            d = os.path.join(base, group, m_key)
            os.makedirs(d, exist_ok=True)
            for i, row in enumerate(np.asarray(arr)[:num_samples]):
                np.save(os.path.join(d, str(i).zfill(6) + ".npy"), row)
    return base


def _host(tree):
    """Host arrays, keys sorted at every level (the order of the jitted
    JAX functions' dicts, which the logs and the eval file follow)."""
    return {k: (_host(v) if isinstance(v, dict) else v.cpu().numpy())
            for k, v in sorted(tree.items())}


@torch.no_grad()
def generate_conditional_samples(exp, model_idx: int = 0,
                                 num_samples: Optional[int] = None,
                                 generator: Optional[torch.Generator] = None):
    """Per-subset conditional generations on the test split's complete
    samples (``cond_generation`` of every subset posterior over the whole
    split): ``({subset: {modality: [n, D]}}, {modality: real [n, D]})``,
    host arrays. ``generator`` defaults to a CPU generator seeded
    ``cfg.seed + 7``."""
    cfg = exp.cfg
    model = exp.models[model_idx]
    dev = next(model.parameters()).device
    dataset = exp.member_datasets(model_idx)[1]
    complete = dataset.idx_per_modality_subset[-1]
    if num_samples is not None:
        complete = complete[:num_samples]
    data, _, _ = dataset.gather(complete)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed + 7)
    latents = model.inference(batch)
    cond = model.cond_generation(latents["subsets"], generator=generator)
    return _host(cond), {k: np.asarray(v) for k, v in data.items()}


@torch.no_grad()
def generate_random_samples(exp, model_idx: int = 0, num_samples: int = 256,
                            generator: Optional[torch.Generator] = None):
    """Unconditional generations from the unit prior (``generate``):
    ``{modality: [num_samples, D]}`` host arrays. ``generator`` defaults to
    a CPU generator seeded ``cfg.seed + 13``."""
    if generator is None:
        generator = torch.Generator().manual_seed(exp.cfg.seed + 13)
    return _host(exp.models[model_idx].generate(int(num_samples),
                                                generator=generator))


def calc_prd_score(exp, model_idx: int = 0, num_clusters: int = 20,
                   num_runs: int = 5, samples=None,
                   embedding=None) -> Dict[str, float]:
    """PRD F-beta scores per (subset, modality). ``samples`` reuses a
    :func:`generate_conditional_samples` result; ``embedding`` maps
    generated and real samples through a feature extractor first."""
    gen, real = (samples if samples is not None
                 else generate_conditional_samples(exp, model_idx))
    embedding = load_embedding(embedding)
    n = len(next(iter(real.values())))
    num_clusters = min(num_clusters, max(2, n // 5))
    scores: Dict[str, float] = {}
    for s_key, mods in gen.items():
        for m_key, samples in mods.items():
            prec, rec = compute_prd_from_embedding(
                _embed(samples, embedding), _embed(real[m_key], embedding),
                num_clusters=num_clusters,
                num_runs=num_runs, seed=exp.cfg.seed)
            f_beta, f_beta_inv = prd_to_max_f_beta_pair(prec, rec)
            scores[f"prd_{s_key}_{m_key}"] = f_beta
            scores[f"prd_inv_{s_key}_{m_key}"] = f_beta_inv
    return scores


def calc_fid_scores(exp, model_idx: int = 0,
                    embedding=None) -> Dict[str, float]:
    """FID per (subset, modality) over feature embeddings."""
    gen, real = generate_conditional_samples(exp, model_idx)
    embedding = load_embedding(embedding)
    return {f"fid_{s_key}_{m_key}": calculate_fid_from_embeddings(
        samples, real[m_key], embedding=embedding)
        for s_key, mods in gen.items() for m_key, samples in mods.items()}
