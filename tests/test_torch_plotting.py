# -*- coding: utf-8 -*-
# The port's plotting against syncopy_tpu on the CPU, under the Agg
# backend: singlepanelplot and multipanelplot of each data class, built
# from the same numpy arrays in both packages, give figures with the same
# axes, lines, images and collections, the same titles and axis labels,
# and the same plotted values.

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import syncopy_tpu as spy  # noqa: E402
import syncopy_tpu_torch as spt  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_and_close_figures():
    """The CPU for the port, the old setting after; close every figure."""
    previous = spt.set_device("cpu")
    yield
    spt.set_device(previous)
    plt.close("all")


FS = 500.0


def _objects(pkg, kind):
    rng = np.random.default_rng(5)
    if kind == "analog":
        return pkg.AnalogData(
            data=rng.normal(size=(600, 3)).astype("f4"), samplerate=FS,
            trialdefinition=np.array([[0, 300, -50], [300, 600, -50]], float),
            channel=["a", "b", "c"])
    if kind == "timelock":
        return pkg.TimeLockData(
            data=rng.normal(size=(200, 2)).astype("f4"), samplerate=FS,
            trialdefinition=np.array([[0, 200, -20]], float))
    if kind == "spectrum":
        return pkg.SpectralData(
            data=rng.uniform(0.1, 2.0, size=(1, 1, 40, 3)).astype("f4"), samplerate=FS,
            freq=np.linspace(1, 80, 40), trialdefinition=np.array([[0, 1, 0]], float))
    if kind == "tfr":
        return pkg.SpectralData(
            data=rng.uniform(0.1, 2.0, size=(2 * 30, 1, 12, 3)).astype("f4"), samplerate=FS,
            freq=np.linspace(5, 60, 12),
            trialdefinition=np.array([[0, 30, -5], [30, 60, -5]], float))
    if kind == "crossspectral":
        csd = rng.uniform(0, 1, size=(1, 25, 3, 3)).astype("f4")
        return pkg.CrossSpectralData(
            data=csd, samplerate=FS, freq=np.linspace(0, 250, 25),
            trialdefinition=np.array([[0, 1, 0]], float))
    spikes = np.column_stack([np.sort(rng.integers(0, 900, 60)), rng.integers(0, 2, 60),
                              rng.integers(0, 3, 60)])
    return pkg.SpikeData(data=spikes, samplerate=1000.0,
                         trialdefinition=np.array([[0, 300, 0], [300, 600, 0], [600, 900, 0]], float))


def _artists(fig):
    """What a reader of the figure sees, per visible axes."""
    out = []
    for ax in fig.get_axes():
        if not ax.get_visible() or not ax.axison:
            continue
        out.append({
            "title": ax.get_title(),
            "xlabel": ax.get_xlabel(),
            "ylabel": ax.get_ylabel(),
            "lines": [(line.get_xdata().tolist(), line.get_ydata().tolist()) for line in ax.lines],
            "images": [np.asarray(im.get_array()).tolist() for im in ax.get_images()],
            "collections": len(ax.collections),
            "legend": [t.get_text() for t in ax.get_legend().get_texts()] if ax.get_legend() else [],
        })
    return out


CASES = [
    ("analog", "single", dict(trials=0)),
    ("analog", "multi", dict(trials=1)),
    ("analog", "single", dict(trials=0, channel=["a", "c"], latency=[0.0, 0.3])),
    ("timelock", "single", dict(shifted=False)),
    ("spectrum", "single", {}),
    ("spectrum", "multi", {}),
    ("tfr", "single", dict(trials=1)),
    ("tfr", "multi", dict(trials=0)),
    ("crossspectral", "single", dict(channel_i=0, channel_j=1)),
    ("spike", "single", dict(trials=0)),
    ("spike", "single", dict(on_yaxis="channel", trials=1)),
    ("spike", "multi", {}),
]


@pytest.mark.parametrize("kind,panels,kwargs", CASES)
def test_figure_matches_jax(kind, panels, kwargs):
    figs = []
    for pkg in (spt, spy):
        plot = pkg.singlepanelplot if panels == "single" else pkg.multipanelplot
        fig, _ = plot(_objects(pkg, kind), **dict(kwargs))
        figs.append(_artists(fig))
    assert figs[0] and figs[0] == figs[1]


def test_method_and_frontend_draw_the_same():
    obj = _objects(spt, "analog")
    fig_a, _ = obj.singlepanelplot(trials=0)
    fig_b, _ = spt.singlepanelplot(obj, trials=0)
    assert _artists(fig_a) == _artists(fig_b)


def test_png_written_under_agg(tmp_path):
    fig, _ = spt.multipanelplot(_objects(spt, "tfr"), trials=0)
    fig.savefig(tmp_path / "tfr.png")
    assert (tmp_path / "tfr.png").stat().st_size > 0


@pytest.mark.parametrize("case", ["event", "too_many_trials", "on_yaxis"])
def test_plot_errors_match_jax(case):
    def call(pkg):
        if case == "event":
            return pkg.singlepanelplot(pkg.EventData(data=np.array([[0, 1], [10, 2]]), samplerate=1000))
        if case == "on_yaxis":
            return pkg.singlepanelplot(_objects(pkg, "spike"), on_yaxis="bogus")
        spd = pkg.synthdata.poisson_noise(nTrials=30, nSpikes=600, nChannels=1, nUnits=1,
                                          samplerate=1000, seed=4)
        return pkg.multipanelplot(spd)
    names = []
    for pkg in (spt, spy):
        with pytest.raises(Exception) as info:
            call(pkg)
        names.append(type(info.value).__name__)
    assert names[0] == names[1] and names[0].startswith("SPY")
