"""Plotting utilities.

Counterpart of ``multivae_tpu/viz/plotting.py``: the same functions, with
matplotlib (and nilearn, where it is installed) imported by the functions
that draw, so the module loads on a machine without them.
Reference: ``experiments/plotting.py`` (``plot_cmat`` ``:30-46``, ``plot_bar``
``:49-152``, ``plot_surf_mosaic`` ``:155-196``, ``plot_areas`` ``:206-261``,
``plot_coefs`` ``:263-278``, ``plot_mosaic`` ``:280-298``) and the radar/
polar plots inside ``workflow.py:905-1238``.

Surface plots resolve in this order: (1) a self-contained surface
atlas (``viz/surface.py`` — pass ``atlas=`` or set ``MULTIVAE_SURFACE_ATLAS``
to an atlas ``.npz``; ``export_fsaverage_atlas`` converts the real fsaverage
once on a connected machine) renders true 3-D views with pure matplotlib;
(2) nilearn when importable; (3) an annotated 2-D summary of the same values
(bar/heatmap), keeping every workflow runnable end to end.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..utils.colors import get_color_list, print_error, print_result


def _pyplot():
    """``matplotlib.pyplot`` on the headless Agg backend."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _nilearn():
    """``(nilearn.datasets, nilearn.plotting)``, or None where nilearn is
    not installed (optional surface rendering)."""
    try:
        from nilearn import datasets as nl_datasets
        from nilearn import plotting as nl_plotting
    except Exception:  # pragma: no cover
        return None
    return nl_datasets, nl_plotting


def plot_cmat(key, cmat, ax=None, figsize=(5, 2), dpi=150, fontsize=16,
              fontweight="bold", title=None):
    """Dissimilarity-matrix heatmap (``plotting.py:30-46``)."""
    plt = _pyplot()
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    ax.imshow(np.asarray(cmat), aspect="auto", cmap="Reds")
    ax.set_title(title if title is not None else key,
                 fontsize=fontsize * 1.5, pad=2, fontweight=fontweight)
    return ax


def plot_bar(key, rsa, ax=None, figsize=(5, 2), dpi=150, fontsize=12,
             labels=None, title=None):
    """Bar plot of model-fit values with scatter overlay
    (simplified ``plotting.py:49-152``)."""
    plt = _pyplot()
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    data = np.asarray(rsa[key])
    n, c = data.shape
    colors = get_color_list(c)
    for i in range(c):
        xs = np.repeat(i, n) + (np.random.rand(n) - 0.5) * 0.25
        ax.scatter(xs, data[:, i], c="k", s=3)
        ax.bar(i, data[:, i].mean(), yerr=data[:, i].std(ddof=1) if n > 1
               else 0, color=(*colors[i][:3], 0.3),
               edgecolor=colors[i])
    if labels is not None:
        ax.set_xticks(np.arange(c), labels=labels, fontsize=fontsize)
    ax.set_ylabel("model fit (r)", fontsize=fontsize)
    ax.spines["top"].set_visible(False)
    ax.spines["right"].set_visible(False)
    if title:
        ax.set_title(title)
    return ax


def _area_fallback(areas, values, save_path, title="ROI areas"):
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, max(2, 0.3 * len(areas))))
    colors = get_color_list(len(areas))
    order = np.argsort(values)
    ax.barh(np.asarray(areas, dtype=object)[order],
            np.asarray(values)[order],
            color=[colors[i] for i in order])
    ax.set_title(title + " (surface rendering unavailable: nilearn not "
                 "installed)", fontsize=9)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path)
        print_result(f"areas plot: {save_path}")
    return fig


def plot_areas(areas: Sequence[str], colors, save_path: Optional[str] = None,
               color_name: str = "Plotly", inflated: bool = True,
               filename: Optional[str] = None, atlas=None):
    """ROI-areas surface plot (``plotting.py:206-261``).

    Renders on a surface atlas when one resolves (``atlas=`` argument or
    the ``MULTIVAE_SURFACE_ATLAS`` env var, see ``viz/surface.py``), else
    through nilearn, else falls back to a labeled bar chart."""
    save_path = save_path or filename
    from .surface import plot_areas_on_atlas, resolve_atlas
    atl = resolve_atlas(atlas)
    if atl is not None:
        try:
            fig = plot_areas_on_atlas(atl, areas, colors,
                                      save_path=save_path)
        except (OSError, KeyError, ValueError) as exc:
            # a globally-set MULTIVAE_SURFACE_ATLAS may not match this
            # cohort's ROI names (or carry stale/renamed arrays); degrade
            # instead of aborting the workflow
            print_error(f"surface atlas does not cover these areas "
                        f"({exc}); using the fallback rendering")
        else:
            if save_path:
                print_result(f"areas surface plot: {save_path}")
            return fig
    nilearn = _nilearn()
    if nilearn is None:
        return _area_fallback(areas, colors, save_path)
    import matplotlib.colors as mcolors

    plt = _pyplot()
    nl_datasets, nl_plotting = nilearn
    destrieux = nl_datasets.fetch_atlas_surf_destrieux()
    fsaverage = nl_datasets.fetch_surf_fsaverage()
    features = [label.decode().replace("_and_", "&")
                for label in destrieux["labels"]]
    lh_features = [f"{item}_lh" for item in features]
    rh_features = [f"{item}_rh" for item in features]
    lh_map = np.zeros(destrieux["map_left"].shape)
    rh_map = np.zeros(destrieux["map_right"].shape)
    palette = get_color_list(len(areas))
    mymap = mcolors.ListedColormap(palette)
    for idx, roi_name in enumerate(areas):
        if "lh" in roi_name:
            roi_index = lh_features.index(roi_name)
            lh_map[destrieux["map_left"] == roi_index] = colors[idx]
        else:
            roi_index = rh_features.index(roi_name)
            rh_map[destrieux["map_right"] == roi_index] = colors[idx]
    fig, axs = plt.subplots(2, 2, subplot_kw={"projection": "3d"})
    template = "infl" if inflated else "pial"
    for row, (hemi, roi_map) in enumerate(
            (("left", lh_map), ("right", rh_map))):
        for col, view in enumerate(("lateral", "medial")):
            nl_plotting.plot_surf_roi(
                fsaverage[f"{template}_{hemi}"], roi_map=roi_map, hemi=hemi,
                view=view, cmap=mymap, bg_map=fsaverage[f"sulc_{hemi}"],
                bg_on_data=True, axes=axs[row, col], alpha=1,
                vmin=0, vmax=len(palette), darkness=0.4)
    if save_path:
        fig.savefig(save_path)
    return fig


def plot_coefs(bar_names, coefs, save_path: Optional[str] = None,
               color_name: str = "Plotly", filename: Optional[str] = None):
    """Horizontal bar chart of coefficients (``plotting.py:263-278``)."""
    plt = _pyplot()
    save_path = save_path or filename
    fig = plt.figure(figsize=(10, 7.5))
    ax = fig.add_subplot(111)
    colors = get_color_list(len(coefs))
    ax.barh(list(bar_names), list(coefs), color=colors)
    ax.tick_params(axis="y", which="both", length=0)
    ax.tick_params(axis="x", which="both", labelsize=15)
    plt.tight_layout()
    if save_path:
        fig.savefig(save_path)
        print_result(f"coefs plot: {save_path}")
    return fig


def plot_surf_mosaic(data, titles, filename, label: bool = True,
                     fsaverage=None, color_name: str = "Plotly"):
    """Mosaic of per-score ROI textures (``plotting.py:155-196``); heatmap
    fallback without nilearn. (With an atlas file, use
    ``viz.surface.plot_mosaic_on_atlas`` — it takes per-ROI value dicts
    instead of nilearn per-vertex textures.)"""
    plt = _pyplot()
    n_plots = len(data)
    nilearn = _nilearn()
    if nilearn is None:
        fig, axes = plt.subplots(n_plots, 1, squeeze=False,
                                 figsize=(10, 2.5 * n_plots))
        for idx in range(n_plots):
            textures = np.concatenate(
                [np.asarray(t).ravel() for t in data[idx]])
            axes[idx, 0].imshow(textures[None, :], aspect="auto",
                                cmap="jet")
            axes[idx, 0].set_yticks([])
            axes[idx, 0].set_title(str(titles[idx]), fontsize=10)
        fig.tight_layout()
        fig.savefig(filename)
        print_result(f"surface mosaic (fallback): {filename}")
        return fig
    nl_datasets, nl_plotting = nilearn
    fsaverage = fsaverage or nl_datasets.fetch_surf_fsaverage()
    size = n_plots * 10 / 4.0
    fig = plt.figure(figsize=(10, size))
    subfigs = fig.subfigures(nrows=n_plots, ncols=1)
    for idx in range(n_plots):
        subfig = subfigs if n_plots == 1 else subfigs[idx]
        subfig.suptitle(f"{titles[idx]}")
        axs = subfig.subplots(nrows=1, ncols=4,
                              subplot_kw={"projection": "3d"})
        for ax in axs:
            ax.axis("off")
        textures = data[idx]
        for hidx, hemi in enumerate(("left", "right")):
            fn = (nl_plotting.plot_surf_roi if label
                  else nl_plotting.plot_surf_stat_map)
            kw = dict(bg_map=fsaverage[f"sulc_{hemi}"], bg_on_data=True,
                      darkness=0.5)
            if label:
                fn(fsaverage[f"infl_{hemi}"], roi_map=textures[0], hemi=hemi,
                   view="lateral", axes=axs[hidx * 2], **kw)
                fn(fsaverage[f"infl_{hemi}"], roi_map=textures[1], hemi=hemi,
                   view="medial", axes=axs[hidx * 2 + 1], **kw)
            else:
                fn(fsaverage[f"infl_{hemi}"], stat_map=textures[0], hemi=hemi,
                   view="medial", cmap="jet", colorbar=False,
                   axes=axs[hidx * 2], **kw)
                fn(fsaverage[f"infl_{hemi}"], stat_map=textures[1], hemi=hemi,
                   view="lateral", cmap="jet", colorbar=False,
                   axes=axs[hidx * 2 + 1], **kw)
    plt.subplots_adjust(left=0.02, bottom=0.02, right=0.98, top=0.98,
                        wspace=0.02, hspace=0.02)
    plt.savefig(filename)
    print_result(f"surface mosaic: {filename}")
    return fig


def plot_mosaic(images, filename, n_cols: int = 8, image_size=(28, 28),
                scaler=None):
    """Image-grid mosaic (``plotting.py:280-298``)."""
    plt = _pyplot()
    images = np.asarray(images)
    n_images = len(images)
    if scaler is not None:
        images = scaler.inverse_transform(images.reshape(n_images, -1))
        images = images.reshape(n_images, *image_size)
    n_rows = (n_images + n_cols - 1) // n_cols
    arr = np.zeros((image_size[0] * n_rows, image_size[1] * n_cols))
    for idx, img in enumerate(images):
        i, j = idx // n_cols, idx % n_cols
        arr[i * image_size[0]:(i + 1) * image_size[0],
            j * image_size[1]:(j + 1) * image_size[1]] = img
    plt.figure(figsize=(10, 10))
    plt.axis("off")
    plt.imshow(arr, cmap="Greys_r")
    plt.savefig(filename)
    print_result(f"mosaic: {filename}")


def plot_radar(values, labels, title, save_path: Optional[str] = None,
               color=None, ax=None):
    """Polar/radar plot of per-ROI coefficients — the matplotlib equivalent of
    the plotly radar used by ``daa_plot_most_connected``
    (``workflow.py:1006-1100``)."""
    plt = _pyplot()
    n = len(labels)
    angles = np.linspace(0, 2 * np.pi, n, endpoint=False).tolist()
    vals = list(np.asarray(values)) + [values[0]]
    angles = angles + [angles[0]]
    if ax is None:
        fig = plt.figure(figsize=(6, 6))
        ax = fig.add_subplot(111, polar=True)
    else:
        fig = ax.figure
    ax.plot(angles, vals, color=color or "C0")
    ax.fill(angles, vals, color=color or "C0", alpha=0.25)
    ax.set_xticks(angles[:-1])
    ax.set_xticklabels(labels, fontsize=7)
    ax.set_title(title)
    if save_path:
        fig.tight_layout()
        fig.savefig(save_path)
        print_result(f"radar plot: {save_path}")
    return fig


def plot_parcats(flows, left_labels, right_labels,
                 save_path: Optional[str] = None, ax=None, title=None,
                 gap_frac: float = 0.25, figsize=(9, 6),
                 left_title="score", right_title="roi"):
    """Parallel-categories flow diagram (sankey-style) in pure matplotlib.

    True equivalent of the reference's plotly ``Parcats`` score->ROI figure
    (``workflow.py:1091-1121``) without the plotly dependency: two columns
    of category bars whose heights are proportional to their total flow,
    connected by cubic-Bezier bands with width proportional to each flow's
    weight and color carrying its sign/category.

    ``flows``: iterable of ``(left_idx, right_idx, weight, color)`` with
    positive weights (use color to encode sign).
    """
    plt = _pyplot()
    from matplotlib.patches import Rectangle
    from matplotlib.path import Path as MplPath
    import matplotlib.patches as mpatches

    # zero-weight flows carry no band and would reference nodes the layout
    # (rightly) omits — drop them up front
    flows = [(int(li), int(ri), float(w), c) for li, ri, w, c in flows
             if float(w) > 0.0]
    n_l, n_r = len(left_labels), len(right_labels)
    tot_l = np.zeros(n_l)
    tot_r = np.zeros(n_r)
    for li, ri, w, _ in flows:
        tot_l[li] += w
        tot_r[ri] += w
    total = max(tot_l.sum(), 1e-12)

    def node_layout(tots):
        """Stack active nodes with uniform gaps; heights ∝ total flow."""
        active = [i for i, t in enumerate(tots) if t > 0]
        n_gaps = max(len(active) - 1, 1)
        gap = gap_frac / n_gaps
        y = 0.0
        span = {}
        for i in active:
            h = (1.0 - gap_frac) * tots[i] / total
            span[i] = (y, y + h)
            y += h + gap
        scale = 1.0 / max(y - gap, 1e-12)
        return {i: (lo * scale, hi * scale) for i, (lo, hi) in span.items()}

    span_l = node_layout(tot_l)
    span_r = node_layout(tot_r)

    # per-node running offsets; order bands by the OTHER side's position to
    # minimize crossings inside each node
    off_l = {i: span_l[i][0] for i in span_l}
    off_r = {i: span_r[i][0] for i in span_r}
    created = ax is None
    if created:
        fig, ax = plt.subplots(figsize=figsize)
    else:
        fig = ax.figure
    x0, x1 = 0.08, 0.92
    for li, ri, w, color in sorted(
            flows, key=lambda f: (span_l[f[0]][0], span_r[f[1]][0])):
        h_l = (span_l[li][1] - span_l[li][0]) * w / tot_l[li]
        h_r = (span_r[ri][1] - span_r[ri][0]) * w / tot_r[ri]
        ya0, ya1 = off_l[li], off_l[li] + h_l
        yb0, yb1 = off_r[ri], off_r[ri] + h_r
        off_l[li] = ya1
        off_r[ri] = yb1
        xm = (x0 + x1) / 2.0
        verts = [(x0, ya0), (xm, ya0), (xm, yb0), (x1, yb0),
                 (x1, yb1), (xm, yb1), (xm, ya1), (x0, ya1), (x0, ya0)]
        codes = [MplPath.MOVETO, MplPath.CURVE4, MplPath.CURVE4,
                 MplPath.CURVE4, MplPath.LINETO, MplPath.CURVE4,
                 MplPath.CURVE4, MplPath.CURVE4, MplPath.CLOSEPOLY]
        ax.add_patch(mpatches.PathPatch(MplPath(verts, codes),
                                        facecolor=color, edgecolor="none",
                                        alpha=0.55))
    bar_w = 0.015
    for i, (lo, hi) in span_l.items():
        ax.add_patch(Rectangle((x0 - bar_w, lo), bar_w, hi - lo,
                               facecolor="0.25", edgecolor="none"))
        ax.text(x0 - 2 * bar_w, (lo + hi) / 2, str(left_labels[i]),
                ha="right", va="center", fontsize=8)
    for i, (lo, hi) in span_r.items():
        ax.add_patch(Rectangle((x1, lo), bar_w, hi - lo,
                               facecolor="0.25", edgecolor="none"))
        ax.text(x1 + 2 * bar_w, (lo + hi) / 2, str(right_labels[i]),
                ha="left", va="center", fontsize=8)
    ax.text(x0 - bar_w / 2, 1.03, left_title, ha="center", fontsize=10)
    ax.text(x1 + bar_w / 2, 1.03, right_title, ha="center", fontsize=10)
    ax.set_xlim(0, 1)
    ax.set_ylim(-0.02, 1.08)
    ax.axis("off")
    if title:
        ax.set_title(title)
    if save_path:
        fig.tight_layout()
        fig.savefig(save_path, dpi=150)
        plt.close(fig)
        print_result(f"parallel-categories flow: {save_path}")
    return fig
