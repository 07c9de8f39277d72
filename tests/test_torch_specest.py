# -*- coding: utf-8 -*-
# Parity of the port's freqanalysis against syncopy_tpu on the CPU, for
# the frequency-resolved methods: mtmfft (every output, keeptrials and
# keeptapers both ways, foi/foilim, every pad, every polyremoval, ragged
# trials, ft_compat, exact_fft), welch, the three FOOOF flavours, the
# frontend's rejections, out= and the cfg provenance; op-level mtmfft and
# mtmfft_exact. The same seeded numpy arrays build both packages'
# AnalogData. Bars: max|port - jax| <= 1e-5 * max|jax| for float32 and
# complex64 outputs, 1e-6 for exact_fft; angles only where |ftr| exceeds
# 1e-3 of its maximum (the angle of a near-zero coefficient is rounding).

import jax
import numpy as np
import pytest
import torch

import syncopy_tpu as spy
import syncopy_tpu_torch as spt
from syncopy_tpu.ops import spectral as jspectral
from syncopy_tpu_torch.ops import spectral as pspectral
from syncopy_tpu_torch.ops.windows import make_tapers
from syncopy_tpu_torch.shared.errors import SPYTypeError, SPYValueError

torch.set_num_threads(1)

FS = 1000.0
REL_TOL = 1e-5
EXACT_TOL = 1e-6


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """Ask the port for the CPU explicitly; restore the setting after."""
    previous = spt.set_device("cpu")
    yield
    spt.set_device(previous)


def _arrays(lens, n_chan, seed, offsets=None):
    """Stacked (samples, channels) float32 payload and its trialdefinition."""
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(int(np.sum(lens)), n_chan)).astype(np.float32)
    bounds = np.concatenate([[0], np.cumsum(lens)])
    trl = np.zeros((len(lens), 3))
    trl[:, 0] = bounds[:-1]
    trl[:, 1] = bounds[1:]
    if offsets is not None:
        trl[:, 2] = offsets
    return data, trl


def _both(lens, n_chan=3, seed=0, offsets=None):
    data, trl = _arrays(lens, n_chan, seed, offsets)
    jdata = spy.AnalogData(data=data, samplerate=FS)
    jdata.trialdefinition = trl
    return spt.from_arrays(data, trl, FS), jdata


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def assert_same_spectra(out, ref, tol=REL_TOL, magnitude=None):
    """Equal data within `tol` of the JAX maximum and equal metadata. For
    angle outputs pass the spectra's magnitude as `magnitude`: angles are
    compared (wrapped at +-pi) only where it exceeds 1e-3 of its maximum."""
    got, want = np.asarray(out.data), np.asarray(ref.data)
    assert got.shape == want.shape
    assert got.dtype == want.dtype
    assert np.isfinite(got).all()
    if magnitude is not None:
        keep = magnitude > 1e-3 * magnitude.max()
        assert keep.mean() > 0.5
        diff = np.angle(np.exp(1j * (got[keep] - want[keep])))
        assert np.abs(diff).max() < tol * np.pi
    else:
        assert _rel_err(got, want) <= tol
    assert out.dimord == ref.dimord
    assert np.array_equal(out.trialdefinition, ref.trialdefinition)
    assert out.samplerate == ref.samplerate
    assert np.allclose(out.freq, ref.freq, rtol=0, atol=1e-12)
    assert list(out.taper) == list(ref.taper)
    assert list(out.channel) == list(ref.channel)
    assert out.cfg.keys() == ref.cfg.keys()
    assert ({k: v for k, v in out.cfg["freqanalysis"].items() if k != "out"}
            == {k: v for k, v in ref.cfg["freqanalysis"].items() if k != "out"})


def _run(pdata, jdata, **kw):
    return spt.freqanalysis(pdata, **kw), spy.freqanalysis(jdata, **kw)


# ------------------------------------------------------------------------ #
# mtmfft
# ------------------------------------------------------------------------ #


@pytest.mark.parametrize("output", ["pow", "abs", "fourier", "real", "imag", "angle",
                                    "absreal", "absimag"])
def test_mtmfft_outputs(output):
    pdata, jdata = _both([400] * 5, seed=1)
    kw = dict(method="mtmfft", tapsmofrq=5, keeptapers=True, output=output)
    out, ref = _run(pdata, jdata, **kw)
    magnitude = None
    if output == "angle":
        magnitude = np.asarray(spy.freqanalysis(jdata, **dict(kw, output="abs")).data)
    assert_same_spectra(out, ref, magnitude=magnitude)
    assert out.data.shape == (5, 3, 201, 3)


@pytest.mark.parametrize("keeptrials", [True, False])
@pytest.mark.parametrize("keeptapers", [True, False])
def test_mtmfft_keeptrials_and_keeptapers(keeptrials, keeptapers):
    pdata, jdata = _both([300] * 6, seed=2)
    out, ref = _run(pdata, jdata, method="mtmfft", tapsmofrq=8, keeptrials=keeptrials,
                    keeptapers=keeptapers)
    assert_same_spectra(out, ref)
    assert out.data.shape[:2] == ((6,) if keeptrials else (1,)) + ((3,) if keeptapers else (1,))


@pytest.mark.parametrize("foi_kw, first, last", [
    ({"foilim": [20, 80]}, 20, 80),
    ({"foi": [10, 20.3, 20.5, 41, 41.2]}, 10, 42),
])
def test_mtmfft_foi_and_foilim(foi_kw, first, last):
    pdata, jdata = _both([500] * 4, seed=3)
    out, ref = _run(pdata, jdata, method="mtmfft", output="fourier", **foi_kw)
    assert_same_spectra(out, ref)
    assert out.freq[0] == first and out.freq[-1] == last


@pytest.mark.parametrize("pad, nfft", [("maxperlen", 500), ("nextpow2", 512), (0.6, 600)])
def test_mtmfft_pad_on_ragged_trials(pad, nfft):
    """Ragged trials padded to one length; each trial's tapers follow its
    own length, and the engine runs one bucket per length."""
    pdata, jdata = _both([500, 430, 500, 371], seed=4)
    out, ref = _run(pdata, jdata, method="mtmfft", pad=pad, tapsmofrq=6)
    assert_same_spectra(out, ref)
    assert out.data.shape == (4, 1, nfft // 2 + 1, 3)


@pytest.mark.parametrize("polyremoval", [None, 0, 1])
def test_mtmfft_polyremoval(polyremoval):
    data, trl = _arrays([300] * 4, 2, seed=5)
    data = data + np.linspace(0, 3, data.shape[0], dtype=np.float32)[:, None]
    jdata = spy.AnalogData(data=data, samplerate=FS)
    jdata.trialdefinition = trl
    out, ref = _run(spt.from_arrays(data, trl, FS), jdata, method="mtmfft",
                    polyremoval=polyremoval, output="fourier")
    assert_same_spectra(out, ref)


def test_mtmfft_ft_compat_and_taper_options():
    pdata, jdata = _both([256, 300, 300], seed=6)
    out, ref = _run(pdata, jdata, method="mtmfft", ft_compat=True, pad="nextpow2",
                    taper="kaiser", taper_opt={"beta": 3.0})
    assert_same_spectra(out, ref)


def test_mtmfft_exact_fft_matches_jax_exact_route():
    """The float64 route against the JAX package's double-float32 DFT, to
    1e-6 of the maximum, with the Granger settings (demeaned tapers); the
    spectra's cfg keeps the flag for connectivityanalysis to read."""
    pdata, jdata = _both([400] * 4, seed=7)
    kw = dict(method="mtmfft", taper="hann", output="fourier", demean_taper=True,
              exact_fft=True, polyremoval=1)
    out, ref = _run(pdata, jdata, **kw)
    assert_same_spectra(out, ref, tol=EXACT_TOL)
    assert out.cfg["freqanalysis"]["exact_fft"] is True


def test_mtmfft_op_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3, 300, 4)).astype(np.float32)
    tapers = make_tapers("dpss", {"NW": 2, "Kmax": 3}, 300, 512, FS)
    for demean in (False, True):
        got = pspectral.mtmfft(torch.from_numpy(x), torch.from_numpy(tapers), 512, demean)
        want = np.asarray(jax.vmap(lambda xi: jspectral.mtmfft(xi, tapers, 512,
                                                               demean_taper=demean))(x))
        assert got.dtype == torch.complex64
        assert _rel_err(got.numpy(), want) <= REL_TOL


def test_mtmfft_exact_op_matches_jax():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 250, 3)).astype(np.float32)
    tapers = make_tapers("hann", None, 250, 250, FS)
    got = pspectral.mtmfft_exact(torch.from_numpy(x), torch.from_numpy(tapers), 250,
                                 polyremoval=None, demean_taper=True)
    want = np.asarray(jax.vmap(lambda xi: jspectral.mtmfft_exact(xi, tapers, 250,
                                                                  demean_taper=True))(x))
    assert got.dtype == torch.complex64
    assert _rel_err(got.numpy(), want) <= EXACT_TOL


def test_exact_route_is_shared_with_the_granger_csd():
    """CrossSpectra's exact_fft spectra are mtmfft_exact's before rounding."""
    from syncopy_tpu_torch.connectivity.ST_compRoutines import CrossSpectra

    rng = np.random.default_rng(10)
    batch = torch.from_numpy(rng.normal(size=(2, 200, 3)).astype(np.float32))
    cfg = dict(nSamples=200, taper="hann", taper_opt=None, samplerate=FS, polyremoval=0,
               demean_taper=True, freq_idx=None)
    tapered, _, nfft = CrossSpectra._tapered_batch(batch, cfg, torch.float64)
    spec = CrossSpectra._batch_spectra(tapered, nfft, cfg).to(torch.complex64)
    tapers = torch.from_numpy(make_tapers("hann", None, 200, 200, FS))
    assert torch.equal(spec, pspectral.mtmfft_exact(batch, tapers, 200, 0, True))


# ------------------------------------------------------------------------ #
# welch and FOOOF
# ------------------------------------------------------------------------ #


@pytest.mark.parametrize("kw", [
    dict(t_ftimwin=0.1, toi=0.5),
    dict(t_ftimwin=0.083, toi=0.75, tapsmofrq=30, keeptrials=False, foilim=[50, 300]),
])
def test_welch(kw):
    pdata, jdata = _both([400, 400, 330], seed=11, offsets=[-100, 0, 50])
    out, ref = _run(pdata, jdata, method="welch", **kw)
    assert_same_spectra(out, ref)
    assert out.data.shape[0] == (3 if kw.get("keeptrials", True) else 1)


def _fooof_data(seed):
    """1/f background plus a 40 Hz rhythm: a spectrum with a peak."""
    rng = np.random.default_rng(seed)
    n, lens = 6, [600] * 6
    t = np.arange(600) / FS
    white = rng.normal(size=(n, 600, 2))
    pink = np.cumsum(white, axis=1) * 0.1 + white
    data = (pink + 1.5 * np.sin(2 * np.pi * 40 * t)[None, :, None]).astype(np.float32)
    data = data.reshape(-1, 2)
    trl = np.zeros((n, 3))
    trl[:, 1] = np.cumsum(lens)
    trl[1:, 0] = trl[:-1, 1]
    jdata = spy.AnalogData(data=data, samplerate=FS)
    jdata.trialdefinition = trl
    return spt.from_arrays(data, trl, FS), jdata


@pytest.mark.parametrize("flavour", ["fooof", "fooof_aperiodic", "fooof_peaks"])
def test_fooof_flavours(flavour):
    pdata, jdata = _fooof_data(12)
    kw = dict(method="mtmfft", output=flavour, keeptrials=False, foilim=[2, 120],
              fooof_opt={"max_n_peaks": 3})
    out, ref = _run(pdata, jdata, **kw)
    assert_same_spectra(out, ref)
    assert set(out.info) == set(ref.info)
    assert out.info["fooof_n_peaks"] == ref.info["fooof_n_peaks"]
    for key in ("fooof_aperiodic_params", "fooof_r_squared"):
        assert np.allclose(out.info[key], ref.info[key], rtol=1e-4, atol=1e-6)


# ------------------------------------------------------------------------ #
# the frontend: rejections, out=, provenance, the device
# ------------------------------------------------------------------------ #


REJECTIONS = [
    dict(method="welch", t_ftimwin=0.1, toi=0.5, output="fourier"),
    dict(method="welch", t_ftimwin=0.1, toi=0.5, keeptapers=True, tapsmofrq=20),
    dict(method="welch", t_ftimwin=0.1, toi="all"),
    dict(method="welch", t_ftimwin=0.1, toi=[0.1, 0.2]),
    dict(method="mtmfft", output="fooof", keeptrials=True),
    dict(method="welch", output="fooof", keeptrials=False, t_ftimwin=0.1, toi=0.5),
    dict(method="mtmfft", output="fourier", tapsmofrq=5),
    dict(method="mtmfft", taper="dpss"),
    dict(method="mtmfft", foi=[10, 20], foilim=[5, 50]),
    dict(method="mtmfft", pad="maxlen"),
    dict(method="mtmfft", polyremoval=2),
    dict(method="mtmconvol", toi=0.5),
    dict(method="mtmconvol", t_ftimwin=2.0, toi=0.5),
    dict(method="mtmconvol", t_ftimwin=0.1, toi="some"),
    dict(method="mtmconvol", t_ftimwin=0.1, toi=[0.2, 0.1]),
    dict(method="mtmconvol", t_ftimwin=0.1, toi=1.5),
    dict(method="wavelet", toi=0.5),
    dict(method="wavelet", wavelet="Haar"),
    dict(method="wavelet", width=0.5),
    dict(method="superlet"),
    dict(method="superlet", order_max=3, order_min=4),
    dict(method="superlet", order_max=2.5),
    dict(method="multitaper"),
    dict(method="mtmfft", output="power"),
]


@pytest.mark.parametrize("kw", REJECTIONS)
def test_frontend_rejects_what_the_jax_package_rejects(kw):
    pdata, jdata = _both([300] * 3, seed=13)
    with pytest.raises(SPYValueError):
        spt.freqanalysis(pdata, **kw)
    with pytest.raises(spy.shared.errors.SPYValueError):
        spy.freqanalysis(jdata, **kw)


def test_frontend_type_errors():
    pdata, _ = _both([300] * 3, seed=14)
    with pytest.raises(SPYTypeError):
        spt.freqanalysis(pdata, keeptrials="yes please")
    with pytest.raises(SPYValueError):
        spt.freqanalysis(spt.SpectralData(), method="mtmfft")


def test_out_and_chained_provenance():
    """A preallocated `out`, a selection, and the cfg chain: the input's
    cfg is carried, then freqanalysis' own, replayable."""
    pdata, jdata = _both([300] * 6, seed=15)
    pdata.cfg.update({"previous": {"a": 1}})
    jdata.cfg.update({"previous": {"a": 1}})
    sel = {"trials": [0, 2, 5], "channel": ["channel1", "channel3"]}
    out = spt.SpectralData()
    got = spt.freqanalysis(pdata, method="mtmfft", tapsmofrq=5, out=out, select=sel)
    ref = spy.freqanalysis(jdata, method="mtmfft", tapsmofrq=5, select=sel)
    assert got is out
    assert_same_spectra(got, ref)
    assert list(got.cfg) == ["previous", "freqanalysis"]
    plain = spt.freqanalysis(pdata, method="mtmfft", tapsmofrq=5, select=sel)
    replay = spt.freqanalysis(pdata, cfg=plain.cfg)
    assert np.array_equal(np.asarray(replay.data), np.asarray(got.data))
    with pytest.raises(SPYValueError):
        spt.freqanalysis(pdata, out=got)


def test_no_card_and_no_request_raises(monkeypatch):
    pdata, _ = _both([200] * 2, seed=16)
    spt.set_device("cuda:0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"set_device\("):
        spt.freqanalysis(pdata, method="mtmfft")
