"""Loading a trained run: numpy-format checkpoints (``checkpoint``) and the
experiment (``experiment``)."""
