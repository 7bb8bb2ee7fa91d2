"""Interpretability analyses: the Digital Avatars Analysis (``daa``), the
site ANOVA (``anova``), RSA (``rsa``), the avatar post-hoc analyses and
the univariate baseline (``avatars``), and their statistics (``stats``)."""
