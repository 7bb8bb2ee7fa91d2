"""Device meshes of the port (counterpart of ``multivae_tpu/parallel``)."""

from .mesh import Mesh, data_mesh, make_mesh, spread, visible_cards

__all__ = ["Mesh", "data_mesh", "make_mesh", "spread", "visible_cards"]
