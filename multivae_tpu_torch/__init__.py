"""multivae_tpu_torch — the PyTorch/CUDA port of ``multivae_tpu``.

The JAX package ``multivae_tpu`` is the reference: every module here mirrors
the module of the same name there and is tested against it on shared inputs.
This package imports ``torch`` and never ``jax``; the only pieces of the JAX
package it reuses by import are jax-free (``multivae_tpu.train.config``,
``multivae_tpu.utils.colors`` and, on the CLI path, ``multivae_tpu.data``).

Layers, from the entry point down:
  * ``cli`` / ``workflows`` — the ``daa`` command (``--device``, default
    ``cuda``);
  * ``train.experiment`` / ``train.checkpoint`` — load a run: config, model,
    numpy-format checkpoint, cohort;
  * ``analysis.daa`` / ``analysis.stats`` — the Digital Avatars Analysis
    pipeline and its regressions;
  * ``models`` — the presence-masked multimodal VAE as ``nn.Module`` s;
  * ``params`` — the weights bridge to and from the JAX param tree;
  * ``ops`` — Gaussian and fusion math, and ``ops.fused_daa``, whose avatar
    sweep runs the hand-written CUDA kernel ``csrc/avatar_sweep.cu`` on a
    CUDA tensor and its plain PyTorch version on a CPU tensor.
"""

__version__ = "0.1.0"
