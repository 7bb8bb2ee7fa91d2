"""Triangulated-surface ROI rendering without nilearn.

A copy of ``multivae_tpu/viz/surface.py`` (numpy; matplotlib imported by
the functions that draw, nilearn only by :func:`export_fsaverage_atlas`).
The reference renders score→ROI associations on the fsaverage cortical
surface through nilearn (``plotting.py:155-196`` ``plot_surf_mosaic``,
``:206-261`` ``plot_areas``). nilearn — and the network fetch of its
meshes — is unavailable offline, so this module renders the same
2×2 (hemisphere × lateral/medial) views from a self-contained *surface
atlas* file with pure matplotlib:

* :class:`SurfaceAtlas` — per-hemisphere vertices/triangles plus a
  per-vertex ROI labeling and the global ROI-name table. ``load``/``save``
  use a single ``.npz``.
* :meth:`SurfaceAtlas.synthetic` — a deterministic two-hemisphere mesh
  (deformed icospheres, nearest-seed ROI patches) so surface rendering is
  fully testable and demo-able without any neuroimaging data; its
  ``roi_names`` can be set to a cohort's base ROI names (e.g. the
  synthetic cohort's ``roi000``…).
* :func:`export_fsaverage_atlas` — one-time conversion of the real
  fsaverage + Destrieux atlas to this format on a machine where nilearn
  IS installed; the resulting ``.npz`` then plugs into every offline
  plot via ``--surface-atlas`` / ``MULTIVAE_SURFACE_ATLAS``.
* :func:`plot_roi_values` / :func:`plot_areas_on_atlas` /
  :func:`plot_mosaic_on_atlas` — Poly3DCollection renderings with
  Lambert shading and per-face ROI colors.

Atlas ``.npz`` schema: ``{left,right}_vertices`` ``[V,3]`` float32,
``{left,right}_faces`` ``[F,3]`` int32, ``{left,right}_labels`` ``[V]``
int32 (index into ``roi_names``; ``-1`` = unlabeled background),
``roi_names`` ``[R]`` unicode, optional ``{left,right}_bg`` ``[V]``
float32 (sulcal-depth-like background shading).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Sequence, Union

import numpy as np

HEMIS = ("left", "right")
ATLAS_ENV_VAR = "MULTIVAE_SURFACE_ATLAS"
_BACKGROUND_GRAY = 0.82


# ---------------------------------------------------------------------------
# mesh construction
# ---------------------------------------------------------------------------
def _icosphere(subdiv: int):
    """Unit icosphere: icosahedron + ``subdiv`` midpoint subdivisions."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    verts = np.array(
        [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
         [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
         [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], dtype=np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
         [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
        dtype=np.int64)
    for _ in range(subdiv):
        verts_list = list(verts)
        mid: Dict[tuple, int] = {}

        def midpoint(a: int, b: int) -> int:
            key = (a, b) if a < b else (b, a)
            if key not in mid:
                m = verts_list[a] + verts_list[b]
                verts_list.append(m / np.linalg.norm(m))
                mid[key] = len(verts_list) - 1
            return mid[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, dtype=np.int64)
    return verts, faces


def _hemisphere_mesh(subdiv: int, hemi: str):
    """A brain-ish hemisphere: ellipsoid-scaled icosphere with a low-
    frequency organic perturbation and a flattened medial wall, offset
    from the midline. Convention: x = left(−)/right(+), y = posterior/
    anterior, z = inferior/superior."""
    verts, faces = _icosphere(subdiv)
    x, y, z = verts[:, 0], verts[:, 1], verts[:, 2]
    bump = 1.0 + 0.06 * np.sin(3.0 * y + 0.7) + 0.04 * np.cos(5.0 * z)
    verts = verts * bump[:, None]
    verts = verts * np.array([0.62, 1.0, 0.78])  # ellipsoid axes
    sign = -1.0 if hemi == "left" else 1.0
    # flatten the medial wall (the side facing the midline)
    medial = sign * verts[:, 0] < 0
    verts[medial, 0] *= 0.35
    verts[:, 0] = sign * (np.abs(verts[:, 0]) + 0.06)
    if hemi == "left":
        # mirroring flips triangle winding; restore consistency
        faces = faces[:, ::-1]
    return verts.astype(np.float32), faces.astype(np.int32)


# ---------------------------------------------------------------------------
# atlas
# ---------------------------------------------------------------------------
@dataclass
class SurfaceAtlas:
    """Two-hemisphere triangulated surface with a per-vertex ROI labeling."""

    vertices: Dict[str, np.ndarray]
    faces: Dict[str, np.ndarray]
    labels: Dict[str, np.ndarray]
    roi_names: Sequence[str]
    bg: Optional[Dict[str, np.ndarray]] = field(default=None)

    def __post_init__(self):
        self.roi_names = [str(n) for n in self.roi_names]
        self._name_to_idx = {n: i for i, n in enumerate(self.roi_names)}
        for hemi in HEMIS:
            if hemi not in self.vertices:
                raise ValueError(f"atlas is missing hemisphere {hemi!r}")
            n_v = len(self.vertices[hemi])
            if len(self.labels[hemi]) != n_v:
                raise ValueError(
                    f"{hemi} labels length {len(self.labels[hemi])} != "
                    f"vertex count {n_v}")
            if self.faces[hemi].size and self.faces[hemi].max() >= n_v:
                raise ValueError(f"{hemi} faces index out of range")
            if (self.labels[hemi].size
                    and self.labels[hemi].max() >= len(self.roi_names)):
                raise ValueError(
                    f"{hemi} labels reference ROI "
                    f"{int(self.labels[hemi].max())} but the atlas has "
                    f"only {len(self.roi_names)} roi_names")

    def roi_index(self, name: str) -> int:
        try:
            return self._name_to_idx[str(name)]
        except KeyError:
            raise ValueError(
                f"ROI {name!r} not in surface atlas (first names: "
                f"{self.roi_names[:5]}...)") from None

    def vertex_values(self, values: Mapping[str, float]):
        """Per-hemisphere per-vertex value arrays (NaN = background)."""
        table = np.full(len(self.roi_names), np.nan, dtype=np.float64)
        for name, value in values.items():
            table[self.roi_index(name)] = float(value)
        out = {}
        for hemi in HEMIS:
            lab = self.labels[hemi]
            vert = np.full(lab.shape, np.nan, dtype=np.float64)
            mask = lab >= 0
            vert[mask] = table[lab[mask]]
            out[hemi] = vert
        return out

    def save(self, path: str) -> str:
        # native <U string dtype: the npz stays loadable with numpy's
        # default allow_pickle=False (safe to share between machines)
        payload = {"roi_names": np.asarray([str(n) for n in
                                            self.roi_names])}
        for hemi in HEMIS:
            payload[f"{hemi}_vertices"] = self.vertices[hemi].astype(
                np.float32)
            payload[f"{hemi}_faces"] = self.faces[hemi].astype(np.int32)
            payload[f"{hemi}_labels"] = self.labels[hemi].astype(np.int32)
            if self.bg is not None and hemi in self.bg:
                payload[f"{hemi}_bg"] = self.bg[hemi].astype(np.float32)
        np.savez_compressed(path, **payload)
        return path

    @classmethod
    def load(cls, path: Union[str, os.PathLike]) -> "SurfaceAtlas":
        with np.load(os.fspath(path)) as data:
            bg = {h: data[f"{h}_bg"] for h in HEMIS
                  if f"{h}_bg" in data.files} or None
            return cls(
                vertices={h: data[f"{h}_vertices"] for h in HEMIS},
                faces={h: data[f"{h}_faces"] for h in HEMIS},
                labels={h: data[f"{h}_labels"] for h in HEMIS},
                roi_names=[str(n) for n in data["roi_names"]],
                bg=bg)

    @classmethod
    def synthetic(cls, roi_names: Optional[Sequence[str]] = None,
                  n_rois: int = 16, subdiv: int = 3,
                  seed: int = 0) -> "SurfaceAtlas":
        """Deterministic synthetic atlas. ``roi_names`` (when given) are
        split across hemispheres in order — pass a cohort's base ROI names
        (e.g. ``roi000``…``roi147``) to render its DAA outputs on a
        surface with zero external data."""
        if roi_names is not None:
            roi_names = [str(n) for n in roi_names]
            n_rois = len(roi_names)
        if n_rois < 2:
            raise ValueError("a synthetic atlas needs >= 2 ROIs "
                             "(one per hemisphere)")
        n_left = (n_rois + 1) // 2
        per_hemi = {"left": list(range(n_left)),
                    "right": list(range(n_left, n_rois))}
        if roi_names is None:
            roi_names = [None] * n_rois
            for hemi in HEMIS:
                for k, idx in enumerate(per_hemi[hemi]):
                    roi_names[idx] = f"roi{k:03d}_{hemi[0]}h"
        rng = np.random.default_rng(seed)
        vertices, faces, labels = {}, {}, {}
        for hemi in HEMIS:
            verts, tri = _hemisphere_mesh(subdiv, hemi)
            ids = per_hemi[hemi]
            seeds = rng.choice(len(verts), size=len(ids), replace=False)
            # nearest-seed patches (euclidean is fine on a convex shell)
            d = np.linalg.norm(verts[:, None, :] - verts[seeds][None, :, :],
                               axis=-1)
            labels[hemi] = np.asarray(ids, dtype=np.int32)[np.argmin(d, 1)]
            vertices[hemi], faces[hemi] = verts, tri
        return cls(vertices=vertices, faces=faces, labels=labels,
                   roi_names=roi_names)


def resolve_atlas(atlas: Union[None, str, os.PathLike, SurfaceAtlas] = None
                  ) -> Optional[SurfaceAtlas]:
    """Resolve an atlas argument: instance → itself; str/path → ``load``;
    None → the ``MULTIVAE_SURFACE_ATLAS`` env var (when set), else None.

    A missing/corrupt atlas file degrades to ``None`` (with an error
    message) instead of raising: the callers invoke this AFTER expensive
    analysis work and every other rendering failure degrades to the
    fallback plot, so a stale ``MULTIVAE_SURFACE_ATLAS`` must not abort a
    whole workflow."""
    if isinstance(atlas, SurfaceAtlas):
        return atlas
    path = ""
    if isinstance(atlas, (str, os.PathLike)) and os.fspath(atlas):
        path = os.fspath(atlas)
    else:
        path = os.environ.get(ATLAS_ENV_VAR, "")
    if not path:
        return None
    try:
        return SurfaceAtlas.load(path)
    except Exception as exc:  # OSError / BadZipFile / KeyError / ValueError
        from ..utils.colors import print_error
        print_error(f"surface atlas {path!r} failed to load "
                    f"({type(exc).__name__}: {exc}); "
                    f"using the fallback rendering")
        return None


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------
_VIEW_AZIM = {  # (hemi, view) -> azimuth at elev=0; x=left(-)/right(+)
    ("left", "lateral"): 180.0, ("left", "medial"): 0.0,
    ("right", "lateral"): 0.0, ("right", "medial"): 180.0,
}


def _render_hemi(ax, verts: np.ndarray, tri: np.ndarray,
                 face_rgba: np.ndarray, hemi: str, view: str) -> None:
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    azim = _VIEW_AZIM[(hemi, view)]
    # Lambert shading toward the camera; |n.cam| tolerates either winding
    cam = np.array([np.cos(np.deg2rad(azim)), np.sin(np.deg2rad(azim)), 0.0])
    p = verts[tri]  # [F, 3, 3]
    normals = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    norms = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = normals / np.maximum(norms, 1e-12)
    shade = 0.35 + 0.65 * np.abs(normals @ cam)
    shaded = face_rgba.copy()
    shaded[:, :3] *= shade[:, None]
    coll = Poly3DCollection(p, facecolors=shaded, edgecolors=shaded,
                            linewidths=0.1)
    ax.add_collection3d(coll)
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    ax.set_xlim(lo[0], hi[0])
    ax.set_ylim(lo[1], hi[1])
    ax.set_zlim(lo[2], hi[2])
    ax.set_box_aspect(tuple(hi - lo))
    ax.view_init(elev=0.0, azim=azim)
    ax.set_axis_off()


def _face_colors(atlas: SurfaceAtlas, vertex_vals: np.ndarray, hemi: str,
                 cmap, vmin: float, vmax: float,
                 categorical: bool = False) -> np.ndarray:
    tri = atlas.faces[hemi]
    vals = vertex_vals[tri]  # [F, 3]
    have = np.isfinite(vals)
    counts = have.sum(axis=1)
    if categorical:
        # codes must not be averaged: a face straddling two areas would
        # take a THIRD area's palette color. Use the face's first finite
        # vertex code instead (boundary faces side with one neighbor).
        first = np.argmax(have, axis=1)
        face_val = vals[np.arange(len(tri)), first]
        face_val = np.where(counts > 0, face_val, 0.0)
    else:
        sums = np.where(have, vals, 0.0).sum(axis=1)
        face_val = np.divide(sums, counts, out=np.zeros(len(tri)),
                             where=counts > 0)
    span = (vmax - vmin) or 1.0
    rgba = np.asarray(cmap(np.clip((face_val - vmin) / span, 0.0, 1.0)))
    background = counts == 0
    rgba[background] = (_BACKGROUND_GRAY,) * 3 + (1.0,)
    if atlas.bg is not None and hemi in atlas.bg:
        depth = atlas.bg[hemi][tri].mean(axis=1)
        lo, hi = float(depth.min()), float(depth.max())
        if hi > lo:
            dim = 0.75 + 0.25 * (depth - lo) / (hi - lo)
            rgba[background, :3] *= dim[background, None]
    return rgba


def plot_roi_values(atlas: SurfaceAtlas, values: Mapping[str, float],
                    save_path: Optional[str] = None, cmap="jet",
                    vmin: Optional[float] = None,
                    vmax: Optional[float] = None,
                    title: Optional[str] = None, fig=None, row=None,
                    categorical: bool = False):
    """2×2 hemisphere×(lateral, medial) surface mosaic of per-ROI values.

    The atlas-file equivalent of the reference's nilearn ``plot_surf_roi``
    mosaics (``plotting.py:206-261``). ``values`` maps ROI names (atlas
    ``roi_names`` entries) to scalars; unmapped ROIs render as background.
    ``categorical=True`` treats values as palette codes (no averaging
    across face vertices). To place the 4 views as one row of a larger
    figure, pass ``fig`` together with ``row=(n_rows, row_idx)``.
    """
    import matplotlib
    import matplotlib.pyplot as plt

    if isinstance(cmap, str):
        cmap = matplotlib.colormaps[cmap]
    finite = [float(v) for v in values.values() if np.isfinite(v)]
    if not finite:
        raise ValueError("plot_roi_values needs at least one finite value")
    vmin = min(finite) if vmin is None else vmin
    vmax = max(finite) if vmax is None else vmax
    vertex_vals = atlas.vertex_values(values)
    own_fig = fig is None
    if own_fig:
        fig, axes = plt.subplots(2, 2, subplot_kw={"projection": "3d"},
                                 figsize=(8, 6))
        axes = axes.ravel()
    else:
        if row is None:
            raise ValueError("plot_roi_values needs row=(n_rows, row_idx) "
                             "whenever an existing fig is passed")
        n_rows, row_idx = row  # panels land on row row_idx of n_rows
        axes = [fig.add_subplot(n_rows, 4, (row_idx - 1) * 4 + i + 1,
                                projection="3d") for i in range(4)]
    panels = [("left", "lateral"), ("left", "medial"),
              ("right", "lateral"), ("right", "medial")]
    for ax, (hemi, view) in zip(axes, panels):
        rgba = _face_colors(atlas, vertex_vals[hemi], hemi, cmap, vmin,
                            vmax, categorical=categorical)
        _render_hemi(ax, atlas.vertices[hemi], atlas.faces[hemi], rgba,
                     hemi, view)
    if title:
        (fig.suptitle if own_fig else axes[0].set_title)(title)
    if own_fig:
        fig.subplots_adjust(left=0.02, right=0.98, top=0.92, bottom=0.02,
                            wspace=0.02, hspace=0.02)
        if save_path:
            fig.savefig(save_path, dpi=130)
    return fig


def plot_areas_on_atlas(atlas: SurfaceAtlas, areas: Sequence[str], colors,
                        save_path: Optional[str] = None):
    """Categorical ROI-areas surface plot — the atlas-file equivalent of
    the reference's ``plot_areas`` (``plotting.py:206-261``): each named
    area gets its palette color, everything else is background."""
    import matplotlib.colors as mcolors

    from ..utils.colors import get_color_list

    palette = get_color_list(len(areas))
    cmap = mcolors.ListedColormap(palette)
    values = {str(name): float(colors[i]) for i, name in enumerate(areas)}
    return plot_roi_values(atlas, values, save_path=save_path, cmap=cmap,
                           vmin=0.0, vmax=float(len(palette)),
                           categorical=True)


def plot_mosaic_on_atlas(atlas: SurfaceAtlas,
                         rows: Sequence[Mapping[str, float]],
                         titles: Sequence[str], filename: str,
                         cmap="jet"):
    """One surface row (4 views) per entry of ``rows`` — the atlas-file
    equivalent of ``plot_surf_mosaic`` (``plotting.py:155-196``)."""
    import matplotlib.pyplot as plt

    n = len(rows)
    fig = plt.figure(figsize=(12, 2.6 * n))
    for idx, values in enumerate(rows):
        plot_roi_values(atlas, values, cmap=cmap, fig=fig,
                        row=(n, idx + 1), title=str(titles[idx]))
    fig.subplots_adjust(left=0.01, right=0.99, top=0.96, bottom=0.02,
                        wspace=0.02, hspace=0.08)
    fig.savefig(filename, dpi=120)
    return fig


# ---------------------------------------------------------------------------
# fsaverage export (requires nilearn; run once, then ship the npz)
# ---------------------------------------------------------------------------
def export_fsaverage_atlas(path: str, mesh: str = "fsaverage5") -> str:
    """Convert the real fsaverage surface + Destrieux labeling into the
    atlas ``.npz`` this module renders from. Requires nilearn (and its
    dataset downloads) — run on a connected machine, then point
    ``MULTIVAE_SURFACE_ATLAS`` at the file everywhere else. ROI names use
    the reference's convention (``plotting.py:219-227``): Destrieux label
    with ``_and_`` → ``&`` plus an ``_lh``/``_rh`` suffix."""
    from nilearn import datasets, surface as nls

    destrieux = datasets.fetch_atlas_surf_destrieux()
    fsavg = datasets.fetch_surf_fsaverage(mesh)
    base = [(lab.decode() if isinstance(lab, bytes) else str(lab))
            .replace("_and_", "&") for lab in destrieux["labels"]]
    roi_names = [f"{n}_lh" for n in base] + [f"{n}_rh" for n in base]
    vertices, faces, labels, bg = {}, {}, {}, {}
    for offset, hemi in ((0, "left"), (len(base), "right")):
        coords, tri = nls.load_surf_mesh(fsavg[f"infl_{hemi}"])
        vertices[hemi] = np.asarray(coords, dtype=np.float32)
        faces[hemi] = np.asarray(tri, dtype=np.int32)
        labels[hemi] = (np.asarray(destrieux[f"map_{hemi}"], dtype=np.int32)
                        + offset)
        bg[hemi] = np.asarray(nls.load_surf_data(fsavg[f"sulc_{hemi}"]),
                              dtype=np.float32)
    atlas = SurfaceAtlas(vertices=vertices, faces=faces, labels=labels,
                         roi_names=roi_names, bg=bg)
    return atlas.save(path)
