"""Math primitives (``gaussian``, ``fusion``) and the fused DAA sweep
(``fused_daa``, whose CUDA kernel is built by ``_build``)."""
