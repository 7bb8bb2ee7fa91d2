"""Visualization layer (matplotlib, imported by the functions that draw;
surface atlas or optional nilearn surface rendering — see
``viz/surface.py``). Counterpart of ``multivae_tpu/viz``."""

from .plotting import (
    plot_areas,
    plot_bar,
    plot_cmat,
    plot_coefs,
    plot_mosaic,
    plot_radar,
    plot_surf_mosaic,
)
from .surface import (
    SurfaceAtlas,
    export_fsaverage_atlas,
    plot_areas_on_atlas,
    plot_mosaic_on_atlas,
    plot_roi_values,
    resolve_atlas,
)

__all__ = ["SurfaceAtlas", "export_fsaverage_atlas", "plot_areas",
           "plot_areas_on_atlas", "plot_bar", "plot_cmat", "plot_coefs",
           "plot_mosaic", "plot_mosaic_on_atlas", "plot_radar",
           "plot_roi_values", "plot_surf_mosaic", "resolve_atlas"]
