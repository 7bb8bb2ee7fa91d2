"""multivae_tpu_torch — the PyTorch/CUDA port of ``multivae_tpu``.

The JAX package ``multivae_tpu`` is the reference: every module here mirrors
the module of the same name there and is tested against it on shared inputs.
This package imports ``torch`` and never ``jax``, nor anything of the JAX
package: modules it needs that hold no JAX code (the config, the data
layer, the print helpers) are copied.

Layers, from the entry point down:
  * ``cli`` / ``workflows`` — the JAX CLI's fourteen commands: ``train``,
    ``resume``, ``eval``, ``daa``, the analyses and the plots
    (``--device``, default ``cuda``, where a model runs);
  * ``viz`` — matplotlib figures (imported by the functions that draw),
    the surface atlas and the MJPEG AVI writer;
  * ``eval`` — IWAE likelihoods, PRD, FID, latent probes and coherence
    (plain torch on the device, numpy on the host);
  * ``train.trainer`` — the per-epoch driver: batching, routes, noise,
    logging (``train.logging``), checkpoints (``train.checkpoint``);
  * ``train.experiment`` — config, models, datasets, train state;
  * ``train.train_step`` / ``train.losses`` — the general autograd step and
    the ELBO losses;
  * ``analysis`` — the Digital Avatars Analysis pipeline, ANOVA, RSA, the
    avatar post-hoc analyses, the univariate baseline and their
    statistics (host numpy, scipy and pandas; RSA's inference on the
    device);
  * ``data`` — cohorts, splits, samplers, scaling (numpy and pandas);
  * ``models`` — the presence-masked multimodal VAE as ``nn.Module`` s;
  * ``parallel`` — device meshes, the tensor-parallel step and the GPipe
    pipeline;
  * ``params`` — the weights bridge to and from the JAX param tree and the
    flat train state;
  * ``ops`` — Gaussian, fusion and likelihood math, and the kernels' Python
    side: ``fused_daa`` (``csrc/avatar_sweep.cu``), ``fused_step``
    (``csrc/mopoe_step.cu``), ``fused_presence`` (``csrc/presence_step.cu``)
    and ``adam`` (``csrc/flat_adam.cu``); each launches its hand-written
    CUDA kernel on a CUDA tensor and runs its plain PyTorch version on a
    CPU tensor.
"""

__version__ = "0.1.0"
