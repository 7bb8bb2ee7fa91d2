"""One Digital Avatars Analysis call in plain PyTorch and NumPy.

Per validation round, from the seed of the call (``default_rng(seed)`` for
the subjects, a ``torch.Generator`` on the device seeded with ``seed`` for
every normal draw, in this order):

* ``B`` subjects drawn without replacement from the test subjects;
* the reconstruction statistics of their clinical block (mean and scale)
  and ROI block (mean): with linear decoders and a per-feature output
  scale the mean of the stochastic reconstructions in closed form, the
  decode of the latent means (the joint by the stratified partition);
  otherwise ``M`` passes, each ``randn(B, cd + sum of styles)``, averaged;
* the likelihood scores ``loc + scale * randn(P, B, S)``;
* the avatars: for every cell ``(p, s)`` (cell ``p S + s``) the clinical
  block with score ``s`` replaced by sample ``p``, through the whole model
  with the noise ``randn(P S, B, w)``: ``w = cd + s_rois`` on the
  architecture of the avatar-sweep kernel (content, then the ROI style),
  ``cd + s_clinical + s_rois`` otherwise (content, then every style);
* per (subject, score, ROI) the sums over samples of the avatar and of the
  score times the avatar, the avatars first rounded to ``fetch_dtype``;
* the two-level regression per score and ROI: per subject the slope
  ``(sum xy - mean(x) sum y) / Sxx``, then their mean and its two-sided
  t-test over subjects (Student-t survival from the regularized incomplete
  beta function, :func:`t_sf`);
* the vote: a link is significant when its p-value is under
  ``0.05 / (S R)`` in at least ``trust_level * n_validation`` rounds.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from . import model as ref


def sweep_architecture(cfg: dict) -> bool:
    """The architecture the avatar-sweep kernel takes: one encoder hidden
    layer, linear decoders, per-feature scale, normal likelihood, styles."""
    return (cfg["num_hidden_layer_encoder"] == 1
            and cfg["num_hidden_layer_decoder"] == 0
            and not cfg["learn_output_sample_scale"]
            and cfg["likelihood"] == "normal"
            and cfg["factorized_representation"])


def _betacf(a, b, x, iters: int = 300):
    """Continued fraction of the incomplete beta function (Lentz)."""
    tiny = 1e-300
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = np.ones_like(x)
    d = 1.0 - qab * x / qap
    d = np.where(np.abs(d) < tiny, tiny, d)
    d = 1.0 / d
    h = d.copy()
    for m in range(1, iters + 1):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        d = np.where(np.abs(d) < tiny, tiny, d)
        c = 1.0 + aa / c
        c = np.where(np.abs(c) < tiny, tiny, c)
        d = 1.0 / d
        h = h * d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        d = np.where(np.abs(d) < tiny, tiny, d)
        c = 1.0 + aa / c
        c = np.where(np.abs(c) < tiny, tiny, c)
        d = 1.0 / d
        delta = d * c
        h = h * delta
        if np.all(np.abs(delta - 1.0) < 1e-15):
            break
    return h


def betainc(a: float, b: float, x):
    """The regularized incomplete beta function ``I_x(a, b)``."""
    x = np.asarray(x, dtype=np.float64)
    out = np.zeros_like(x)
    inner = (x > 0) & (x < 1)
    out[x >= 1] = 1.0
    xi = x[inner]
    with np.errstate(divide="ignore"):
        lbt = (math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)
               + a * np.log(xi) + b * np.log1p(-xi))
    low = xi < (a + 1.0) / (a + b + 2.0)
    val = np.empty_like(xi)
    val[low] = np.exp(lbt[low]) * _betacf(a, b, xi[low]) / a
    hi = ~low
    val[hi] = 1.0 - np.exp(lbt[hi]) * _betacf(b, a, 1.0 - xi[hi]) / b
    out[inner] = val
    return out


def t_sf(t, nu: float):
    """Student-t survival ``P(T > t)`` for ``t >= 0`` (``inf`` gives 0)."""
    t = np.asarray(t, dtype=np.float64)
    with np.errstate(over="ignore", invalid="ignore"):
        x = np.where(np.isinf(t), 0.0, nu / (nu + t * t))
    return 0.5 * betainc(0.5 * nu, 0.5, x)


def hierarchical(x, ysum, xysum):
    """``(pvalues [R], coefs [R])`` of one score: ``x [B, P]`` float64,
    ``ysum``/``xysum`` ``[B, R]``."""
    xmean = x.mean(axis=1)
    sxx = ((x - xmean[:, None]) ** 2).sum(axis=1)
    betas = (xysum - xmean[:, None] * ysum) / sxx[:, None]
    g = betas.shape[0]
    coefs = betas.mean(axis=0)
    se = betas.std(axis=0, ddof=1) / math.sqrt(g)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(se > 0, coefs / se, np.inf)
    return 2.0 * t_sf(np.abs(t), g - 1), coefs


@torch.no_grad()
def reconstruction(p, cfg, data, gen, M: int, tf32: bool):
    """``(clinical loc, clinical scale, rois loc)`` ``[B, d]``."""
    names = ref.mod_names(cfg)
    if sweep_architecture(cfg):
        out = ref.forward(p, cfg, data, None, tf32, sample=False)
        (c_loc, c_lv), (r_loc, _) = out["rec"][names[0]], out["rec"][names[1]]
        return c_loc, torch.exp(0.5 * c_lv), r_loc
    b = data[names[0]].shape[0]
    width = cfg["class_dim"] + sum(ref.style_dims(cfg))
    eps = torch.stack([torch.randn((b, width), generator=gen,
                                   device=gen.device) for _ in range(M)])
    sums = [0.0, 0.0, 0.0]
    for lo in range(0, M, 100):
        out = ref.forward(p, cfg, data, eps[lo:lo + 100], tf32)
        (c_loc, c_lv), (r_loc, _) = out["rec"][names[0]], out["rec"][names[1]]
        for i, part in enumerate((c_loc, torch.exp(0.5 * c_lv), r_loc)):
            sums[i] = sums[i] + part.double().sum(dim=0)
    return tuple((s / M).float() for s in sums)


@torch.no_grad()
def avatars(p, cfg, data, scores, eps, tf32: bool, block: int = 150):
    """ROI avatars ``[P S, B, R]`` of every cell; ``scores [P, B, S]``."""
    names = ref.mod_names(cfg)
    n_p, b, n_s = scores.shape
    clinical, rois = data[names[0]], data[names[1]]
    eye = torch.eye(n_s, device=clinical.device)
    cells = (clinical[None, None] * (1.0 - eye)[None, :, None, :]
             + scores.permute(0, 2, 1)[:, :, :, None] * eye[None, :, None, :]
             ).reshape(n_p * n_s, b, n_s)
    s1, s2 = ref.style_dims(cfg)[:2]
    cd = cfg["class_dim"]
    # the noise columns of the ROI style: after the content's, and after
    # the clinical style's outside the sweep kernel's architecture
    off = cd if sweep_architecture(cfg) else cd + s1
    out = []
    for lo in range(0, n_p * n_s, block):
        c = cells[lo:lo + block]
        n = c.shape[0]
        e = eps[lo:lo + block]
        batch = {names[0]: c, names[1]: rois.expand(n, -1, -1)}
        enc, smu, slv = ref.posteriors(p, cfg, batch, tf32)
        owner = ref.partition(smu.shape[0], b)
        jmu, jlv = ref.select_rows(smu, owner), ref.select_rows(slv, owner)
        zc = jmu + e[..., :cd] * torch.exp(0.5 * jlv)
        zs = enc[names[1]][2] + e[..., off:off + s2] * torch.exp(
            0.5 * enc[names[1]][3])
        loc, _ = ref.decode(p, cfg, names[1], cfg["input_dim"][1], zs, zc,
                            tf32)
        out.append(loc)
    return torch.cat(out)


def follow_call(cfg: dict, cohort: Dict[str, np.ndarray],
                weights: Dict[str, torch.Tensor], seed: int,
                n_validation: int, device, tf32: bool = False,
                wire=torch.float16, half_batch: bool = False):
    """Every output of one call: per round ``subjects``, ``recon [B, R]``,
    ``scores [B, P, S]``, ``ysum``/``xysum`` ``[B, S, R]``; ``pvalues``
    and ``coefs`` ``[n_validation, S, R]``; the vote ``[S, R]``.
    ``tf32`` and ``half_batch`` (the regressions over the first half of
    each round's subjects) are the controls the comparison has to fail."""
    names = ref.mod_names(cfg)
    p = {k: v.detach().to(device).float() for k, v in weights.items()}
    n_p, b, M = cfg["daa_n_samples"], cfg["daa_n_subjects"], cfg["daa_M"]
    test = {names[0]: cohort["test_clinical"], names[1]: cohort["test_rois"]}
    n_complete = len(cohort["test_metadata"])
    b = min(b, n_complete)
    np_rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n_s = cfg["n_scores"]
    s1, s2 = ref.style_dims(cfg)[:2]
    sweep_w = cfg["class_dim"] + (s2 if sweep_architecture(cfg)
                                  else s1 + s2)
    res = {k: [] for k in ("subjects", "recon", "scores", "ysum", "xysum")}
    pvalues = np.zeros((n_validation, n_s, cfg["n_rois"]))
    coefs = np.zeros_like(pvalues)
    for r in range(n_validation):
        sel = np_rng.choice(n_complete, size=b, replace=False)
        res["subjects"].append(cohort["test_metadata"][sel, 0])
        data = {m: torch.as_tensor(test[m][sel], device=device)
                for m in names}
        c_loc, c_scale, r_loc = reconstruction(p, cfg, data, gen, M, tf32)
        res["recon"].append(r_loc.cpu().numpy())
        e = torch.randn((n_p,) + tuple(c_loc.shape), generator=gen,
                        device=device)
        scores = c_loc[None] + c_scale[None] * e                # [P, B, S]
        eps = torch.randn((n_p * n_s, b, sweep_w), generator=gen,
                          device=device)
        y = avatars(p, cfg, data, scores, eps, tf32)            # [P S, B, R]
        y = y.to(wire).double().reshape(n_p, n_s, b, -1)
        x = scores.double()
        ysum = y.sum(dim=0).permute(1, 0, 2)                    # [B, S, R]
        xysum = torch.einsum("psbr,pbs->bsr", y, x)
        res["ysum"].append(ysum.cpu().numpy())
        res["xysum"].append(xysum.cpu().numpy())
        host_scores = scores.permute(1, 0, 2).cpu().numpy()     # [B, P, S]
        res["scores"].append(host_scores)
        rows = slice(0, b // 2 if half_batch else b)
        for s in range(n_s):
            pv, cf = hierarchical(
                host_scores[rows, :, s].astype(np.float64),
                res["ysum"][-1][rows, s], res["xysum"][-1][rows, s])
            pvalues[r, s], coefs[r, s] = pv, cf
    thr = 0.05 / cfg["n_rois"] / n_s
    vote = (pvalues < thr).sum(axis=0) >= n_validation * cfg[
        "daa_trust_level"]
    out = {k: np.asarray(v) for k, v in res.items()}
    out.update(pvalues=pvalues, coefs=coefs, vote=vote, threshold=thr)
    return out
