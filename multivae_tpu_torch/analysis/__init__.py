"""Interpretability analyses: the Digital Avatars Analysis (``daa``) and
its regressions (``stats``)."""
