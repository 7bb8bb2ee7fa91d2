"""Device meshes, tensor parallelism and the GPipe pipeline of the port
(counterpart of ``multivae_tpu/parallel``). The tensor-parallel step lives
in :mod:`.tensor`, imported where it runs."""

from .mesh import (
    Mesh,
    data_mesh,
    make_mesh,
    spread,
    tp_mesh,
    tp_param_spec,
    visible_cards,
)
from .pipeline import pipe_mesh, pipeline_apply, stack_stages

__all__ = ["Mesh", "data_mesh", "make_mesh", "pipe_mesh", "pipeline_apply",
           "spread", "stack_stages", "tp_mesh", "tp_param_spec",
           "visible_cards"]
