"""The port's visualization layer and its host helpers on the CPU, held to
the JAX package: the synthetic surface atlas (meshes, labels, per-vertex
values, the ``.npz`` format) and ``resolve_atlas``'s rules equal; every
plot function writes a non-empty PNG; the MJPEG AVI writer writes the JAX
package's bytes from the same frames; the cohort names and the color
helpers equal."""

import os

import numpy as np
import pytest

from multivae_tpu import constants as jax_constants
from multivae_tpu.data import cohorts as jax_cohorts
from multivae_tpu.utils import colors as jax_colors
from multivae_tpu.viz import surface as jax_surface
from multivae_tpu.viz import video as jax_video
from multivae_tpu_torch import constants
from multivae_tpu_torch.data import cohorts
from multivae_tpu_torch.utils import colors
from multivae_tpu_torch.viz import plotting, surface, video

ATLAS_CASES = {
    "default": {},
    "cohort names": {"roi_names": [f"roi{i:03d}" for i in range(9)],
                     "subdiv": 2, "seed": 1},
    "five rois": {"n_rois": 5, "subdiv": 1, "seed": 3},
}


def assert_atlas_equal(a, b):
    assert list(a.roi_names) == list(b.roi_names)
    for hemi in surface.HEMIS:
        for field in ("vertices", "faces", "labels"):
            got, want = getattr(a, field)[hemi], getattr(b, field)[hemi]
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    assert (a.bg is None) == (b.bg is None)


@pytest.mark.parametrize("case", sorted(ATLAS_CASES))
def test_synthetic_atlas_equals_jax(case, tmp_path):
    kw = ATLAS_CASES[case]
    ours = surface.SurfaceAtlas.synthetic(**kw)
    theirs = jax_surface.SurfaceAtlas.synthetic(**kw)
    assert_atlas_equal(ours, theirs)
    rng = np.random.default_rng(0)
    values = {n: float(rng.normal()) for n in ours.roi_names[::2]}
    got, want = ours.vertex_values(values), theirs.vertex_values(values)
    for hemi in surface.HEMIS:
        np.testing.assert_array_equal(got[hemi], want[hemi])
    path = ours.save(str(tmp_path / "atlas.npz"))
    assert_atlas_equal(surface.SurfaceAtlas.load(path),
                       jax_surface.SurfaceAtlas.load(path))
    with pytest.raises(ValueError, match="not in surface atlas"):
        ours.roi_index("nowhere")


def resolve_cases(tmp_path):
    path = surface.SurfaceAtlas.synthetic(n_rois=4, subdiv=1).save(
        str(tmp_path / "a.npz"))
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not an npz")
    return {"path": (path, None), "env": (None, path), "empty string env":
            ("", path), "nothing": (None, None), "missing": (
                str(tmp_path / "missing.npz"), None), "corrupt": (
                    str(bad), None), "env missing": (
                        None, str(tmp_path / "missing.npz"))}


@pytest.mark.parametrize("case", ["path", "env", "empty string env",
                                  "nothing", "missing", "corrupt",
                                  "env missing"])
def test_resolve_atlas_follows_the_jax_rules(case, tmp_path, monkeypatch):
    arg, env = resolve_cases(tmp_path)[case]
    if env is None:
        monkeypatch.delenv(surface.ATLAS_ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(surface.ATLAS_ENV_VAR, env)
    assert surface.ATLAS_ENV_VAR == jax_surface.ATLAS_ENV_VAR
    got, want = surface.resolve_atlas(arg), jax_surface.resolve_atlas(arg)
    assert (got is None) == (want is None)
    if want is not None:
        assert_atlas_equal(got, want)
    atlas = surface.SurfaceAtlas.synthetic(n_rois=4, subdiv=1)
    assert surface.resolve_atlas(atlas) is atlas


def plot_calls(tmp_path):
    """``name -> (callable writing a PNG, path)``."""
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(1)
    atlas = surface.SurfaceAtlas.synthetic(
        roi_names=[f"roi{i:03d}" for i in range(6)], subdiv=1)
    areas = ["roi001", "roi004", "roi002"]
    flows = [(0, 0, 0.5, "#c0392b"), (1, 1, 0.2, "#2980b9"),
             (1, 0, 0.1, "#2980b9")]

    def on_ax(fn, *args, **kw):
        def run(path):
            ax = fn(*args, **kw)
            ax.figure.savefig(path)
            plt.close(ax.figure)
        return run

    calls = {
        "plot_cmat": on_ax(plotting.plot_cmat, "joint",
                           rng.normal(size=(8, 8))),
        "plot_bar": on_ax(plotting.plot_bar, "r",
                          {"r": rng.normal(size=(6, 3))},
                          labels=["a", "b", "c"], title="fit"),
        "plot_areas fallback": lambda p: plotting.plot_areas(
            areas, np.arange(3) + 0.01, save_path=p),
        "plot_areas on an atlas": lambda p: plotting.plot_areas(
            areas, np.arange(3) + 0.01, save_path=p, atlas=atlas),
        "plot_coefs": lambda p: plotting.plot_coefs(areas,
                                                    rng.normal(size=3),
                                                    save_path=p),
        "plot_surf_mosaic fallback": lambda p: plotting.plot_surf_mosaic(
            [[rng.normal(size=10), rng.normal(size=10)]] * 2, ["a", "b"],
            p),
        "plot_mosaic": lambda p: plotting.plot_mosaic(
            rng.uniform(size=(5, 6, 6)), p, n_cols=4, image_size=(6, 6)),
        "plot_radar": lambda p: plotting.plot_radar(
            rng.normal(size=5), list("abcde"), "radar", save_path=p),
        "plot_parcats": lambda p: plotting.plot_parcats(
            flows, ["s0", "s1"], ["r0", "r1"], save_path=p, title="flow"),
        "plot_roi_values": lambda p: surface.plot_roi_values(
            atlas, {"roi000": 1.0, "roi003": -0.5}, save_path=p,
            title="values"),
        "plot_areas_on_atlas": lambda p: surface.plot_areas_on_atlas(
            atlas, areas, np.arange(3) + 0.01, save_path=p),
        "plot_mosaic_on_atlas": lambda p: surface.plot_mosaic_on_atlas(
            atlas, [{"roi000": 1.0}, {"roi005": 2.0, "roi001": 0.5}],
            ["one", "two"], p),
    }
    return {name: (fn, str(tmp_path / f"{name.replace(' ', '_')}.png"))
            for name, fn in calls.items()}


PLOTS = ("plot_cmat", "plot_bar", "plot_areas fallback",
         "plot_areas on an atlas", "plot_coefs",
         "plot_surf_mosaic fallback", "plot_mosaic", "plot_radar",
         "plot_parcats", "plot_roi_values", "plot_areas_on_atlas",
         "plot_mosaic_on_atlas")


@pytest.mark.parametrize("name", PLOTS)
def test_plot_function_writes_a_png(name, tmp_path, monkeypatch):
    import matplotlib.pyplot as plt

    monkeypatch.delenv(surface.ATLAS_ENV_VAR, raising=False)
    fn, path = plot_calls(tmp_path)[name]
    fn(path)
    plt.close("all")
    with open(path, "rb") as fh:
        head = fh.read(8)
    assert head == b"\x89PNG\r\n\x1a\n"
    assert os.path.getsize(path) > 1000


def frames(n=5, h=24, w=40, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
            for _ in range(n)]


@pytest.mark.parametrize("n, fps", [(1, 4), (5, 4), (20, 10)])
def test_write_mjpeg_avi_writes_the_jax_bytes(tmp_path, n, fps):
    rgb = frames(n)
    ours = video.write_mjpeg_avi(str(tmp_path / "a.avi"), rgb, fps=fps)
    theirs = jax_video.write_mjpeg_avi(str(tmp_path / "b.avi"), rgb, fps=fps)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        got = a.read()
        assert got == b.read()
    assert got[:4] == b"RIFF" and got[8:12] == b"AVI "
    assert got.count(b"00dc") == 2 * n


def test_write_mjpeg_avi_refuses_what_the_jax_writer_refuses(tmp_path):
    bad = [[], [np.zeros((4, 4), np.uint8)],
           frames(2)[:1] + [np.zeros((24, 40, 3), np.float32)]]
    for case in bad:
        for writer in (video.write_mjpeg_avi, jax_video.write_mjpeg_avi):
            with pytest.raises(ValueError):
                writer(str(tmp_path / "x.avi"), case)


def test_figure_to_rgb_equals_jax():
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(3, 2))
    ax.imshow(np.arange(12).reshape(3, 4), cmap="jet")
    got, want = video.figure_to_rgb(fig), jax_video.figure_to_rgb(fig)
    plt.close(fig)
    assert got.dtype == np.uint8 and got.shape[2] == 3
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["G_precentral_lh_thickness", "roi003_area",
                                  "nometric", "a_b_c_d"])
def test_split_roi_metric_equals_jax(name):
    assert cohorts.split_roi_metric(name) == jax_cohorts.split_roi_metric(
        name)


@pytest.mark.parametrize("dataset", ["euaims", "hbn", "synthetic"])
def test_short_clinical_names_equal_jax(dataset):
    names = ["t1_srs_rawscore", "score_0", "SRS_Total"]
    for args in ((dataset,), (dataset, names)):
        assert (cohorts.get_short_clinical_names(*args)
                == jax_cohorts.get_short_clinical_names(*args))
    assert cohorts.short_clinical_names == jax_cohorts.short_clinical_names
    for attr in ("indices", "modalities", "short_clinical_names"):
        assert getattr(constants, attr) == getattr(jax_constants, attr)
    assert constants.get_short_clinical_names is \
        cohorts.get_short_clinical_names


def test_color_helpers_equal_jax(capsys):
    assert colors.get_color_list(23) == jax_colors.get_color_list(23)
    colors.print_command("cmd")
    colors.print_error("err")
    assert capsys.readouterr().out == "cmd\nerr\n"
