# -*- coding: utf-8 -*-
# Parity of the port's filtering ops (syncopy_tpu_torch/ops/filtering.py,
# ops/iir_kernels.py) against syncopy_tpu/ops/filtering.py on JAX-CPU in
# x64, from the same seeded numpy arrays. The JAX functions take one (T, C)
# trial, the port's a (N, T, C) batch: each trial is held to its JAX
# result. Bars, each with its reason:
# - the host designs (windowed sinc, minimum phase, Butterworth sos, the
#   resampling kernel) are the same numpy/scipy code: equal bit for bit;
# - apply_fir, hilbert, resample_poly: float32 FFTs on both sides (pocketfft
#   against ducc), 1e-5 of the JAX maximum;
# - the plain Butterworth cascade (the kernel's arithmetic) against the
#   JAX float64 associative scan: 1e-9 of the JAX maximum; two float64
#   evaluation orders of a stable recurrence differ by rounding amplified by
#   the filter's memory (orders 1-8 here: below 3e-14). A sharp low-pass
#   (2 Hz at 1 kHz: poles within ~1e-2 of the unit circle, a memory of
#   thousands of samples) amplifies about a thousand times more (1.4e-11
#   on its input here); its bar is 1e-10.

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncopy_tpu.ops import filtering as jfilt
from syncopy_tpu.preproc.resampledata import _get_updn as j_get_updn
from syncopy_tpu_torch.ops import filtering as pfilt
from syncopy_tpu_torch.ops import iir_kernels as ik
from syncopy_tpu_torch.preproc.resampledata import _get_updn as p_get_updn

torch.set_num_threads(1)

FS = 1000.0
FFT_TOL = 1e-5
IIR_TOL = 1e-9
SHARP_IIR_TOL = 1e-10


def _batch(N, T, C, seed, dtype=np.float64):
    return np.random.default_rng(seed).normal(size=(N, T, C)).astype(dtype)


def _rel_err(got, want):
    ok = ~np.isnan(want)
    return float(np.abs(got[ok] - want[ok]).max() / np.abs(want[ok]).max())


def _jax_per_trial(fn, x):
    """`fn` of the JAX package on each (T, C) trial of the numpy batch."""
    return np.stack([np.asarray(fn(jnp.asarray(trial))) for trial in x])


# ------------------------------------------------------------------------ #
# host designs: bit for bit
# ------------------------------------------------------------------------ #


@pytest.mark.parametrize("window", ["hamming", "hann", "blackman"])
@pytest.mark.parametrize("ftype, f_c", [("lp", 0.1), ("hp", 0.2), ("bp", [0.05, 0.2]),
                                         ("bs", [0.1, 0.15])])
@pytest.mark.parametrize("order", [100, 101, 400])
def test_design_wsinc_bit_for_bit(window, ftype, f_c, order):
    got = pfilt.design_wsinc(window, order, f_c, ftype)
    want = jfilt.design_wsinc(window, order, f_c, ftype)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_windowed_and_inverted_sinc_bit_for_bit():
    assert np.array_equal(pfilt.windowed_sinc("hann", 50, 0.13), jfilt.windowed_sinc("hann", 50, 0.13))
    k = jfilt.windowed_sinc("hamming", 60, 0.2)
    assert np.array_equal(pfilt.invert_sinc(k.copy()), jfilt.invert_sinc(k.copy()))


@pytest.mark.parametrize("order", [30, 100])
def test_minphaserceps_bit_for_bit_and_cached(order):
    kernel = jfilt.design_wsinc("hamming", order, 0.1, "lp")
    want = jfilt.minphaserceps(kernel)
    got = pfilt.minphaserceps(kernel)
    assert np.array_equal(got, want)
    # a second call takes the cache and hands out its own copy
    got[0] += 1.0
    assert np.array_equal(pfilt.minphaserceps(kernel), want)


@pytest.mark.parametrize("ftype, freq", [("lp", 40.0), ("hp", 20.0), ("bp", [30.0, 100.0]),
                                          ("bs", [45.0, 55.0])])
@pytest.mark.parametrize("order", [1, 4, 8])
def test_butter_sos_bit_for_bit(ftype, freq, order):
    got = pfilt.butter_sos(order, freq, ftype, FS)
    want = jfilt.butter_sos(order, freq, ftype, FS)
    assert got.dtype == np.float64 and np.array_equal(got, want)


@pytest.mark.parametrize("orig, new, lpfreq, order", [(1000.0, 250.0, None, None),
                                                       (1000.0, 750.0, None, None),
                                                       (1000.0, 300.0, 100.0, 200)])
def test_resample_kernel_bit_for_bit(orig, new, lpfreq, order):
    up, down = p_get_updn(orig, new)
    assert (up, down) == j_get_updn(orig, new)
    got = pfilt._resample_kernel(up, down, 400, lpfreq, order, orig)
    want = jfilt._resample_kernel(up, down, 400, lpfreq, order, orig)
    assert np.array_equal(got, want)


# ------------------------------------------------------------------------ #
# FFT routes: 1e-5 of the JAX maximum
# ------------------------------------------------------------------------ #


@pytest.mark.parametrize("T, order", [(300, 100), (257, 60), (64, 200)])
def test_apply_fir_matches_jax(T, order):
    x = _batch(3, T, 4, seed=T, dtype=np.float32)
    kernel = jfilt.design_wsinc("hamming", order, [0.05, 0.2], "bp")
    got = pfilt.apply_fir(torch.from_numpy(x), kernel).numpy()
    want = _jax_per_trial(lambda t: jfilt.apply_fir(t, kernel), x)
    assert got.shape == want.shape == x.shape and got.dtype == np.float32
    assert _rel_err(got, want) <= FFT_TOL


@pytest.mark.parametrize("T", [300, 301])
def test_hilbert_matches_jax(T):
    x = _batch(3, T, 4, seed=T, dtype=np.float32)
    got = pfilt.hilbert(torch.from_numpy(x)).numpy()
    want = _jax_per_trial(jfilt.hilbert, x)
    assert got.dtype == np.complex64 and got.shape == want.shape
    assert _rel_err(got, want) <= FFT_TOL
    # the analytic signal's real part is the signal
    assert np.abs(got.real - x).max() <= FFT_TOL * np.abs(x).max()


@pytest.mark.parametrize("orig, new", [(1000.0, 250.0), (1000.0, 750.0), (1000.0, 300.0)])
def test_resample_poly_matches_jax(orig, new):
    x = _batch(2, 300, 3, seed=7, dtype=np.float32)
    up, down = p_get_updn(orig, new)
    kernel = pfilt._resample_kernel(up, down, 300, None, None, orig)
    got = pfilt.resample_poly(torch.from_numpy(x), up, down, kernel).numpy()
    want = _jax_per_trial(lambda t: jfilt.resample_poly(t, up, down, kernel), x)
    assert got.shape == want.shape == (2, int(np.ceil(300 * up / down)), 3)
    assert _rel_err(got, want) <= FFT_TOL


def test_downsample_matches_jax():
    x = _batch(2, 301, 3, seed=8, dtype=np.float32)
    got = pfilt.downsample(torch.from_numpy(x), 4).numpy()
    assert np.array_equal(got, _jax_per_trial(lambda t: jfilt.downsample(t, 4), x))


# ------------------------------------------------------------------------ #
# the Butterworth cascade: the plain version against the float64 scan
# ------------------------------------------------------------------------ #


def _jax_cascades(x, sos):
    """The JAX package's float64 sosfiltfilt and sosfilt of each trial of
    `x`, one compiled program for both (its eager scan compiles op by op)."""
    both = jax.jit(jax.vmap(lambda t: (jfilt.sosfiltfilt(sos, t), jfilt.sosfilt(sos, t))))
    return tuple(np.asarray(a) for a in both(jnp.asarray(x)))


def _iir_pairs(x, sos):
    """(port, JAX) float64 results, twopass then onepass."""
    wants = _jax_cascades(x, sos)
    pairs = []
    for twopass, want in zip((True, False), wants):
        got = ik.sosfilt_float64_plain(torch.from_numpy(x), sos, twopass).numpy()
        assert want.dtype == np.float64 and got.dtype == np.float64
        pairs.append((got, want))
    return pairs


@pytest.mark.parametrize("ftype, freq", [("lp", 40.0), ("hp", 20.0), ("bp", [30.0, 100.0]),
                                          ("bs", [45.0, 55.0])])
@pytest.mark.parametrize("order", range(1, 9))
def test_plain_cascade_matches_jax_scan(ftype, freq, order):
    x = _batch(2, 129, 3, seed=order)
    sos = pfilt.butter_sos(order, freq, ftype, FS)
    for got, want in _iir_pairs(x, sos):
        assert np.isfinite(got).all()
        assert _rel_err(got, want) <= IIR_TOL


@pytest.mark.parametrize("T", [2, 5, 16, 28])
def test_plain_cascade_short_trials(T):
    """T below 3 * ntaps + 1 = 28 at order 4 band-pass: padlen is cut to
    T - 1 (one sample of extension at T = 2)."""
    sos = pfilt.butter_sos(4, [30.0, 100.0], "bp", FS)
    assert ik.sosfilt_padlen(sos, T) == min(27, T - 1)
    for got, want in _iir_pairs(_batch(2, T, 3, seed=T), sos):
        assert _rel_err(got, want) <= IIR_TOL


def test_plain_cascade_first_order_sections():
    """Odd low-pass orders end in a first-order section: ntaps drops by one."""
    sos = pfilt.butter_sos(3, 40.0, "lp", FS)
    assert ik.sosfilt_padlen(sos, 1000) == 3 * (2 * 2 + 1 - 1)
    for got, want in _iir_pairs(_batch(2, 201, 2, seed=3), sos):
        assert _rel_err(got, want) <= IIR_TOL


def test_plain_cascade_nan_trials():
    """A NaN sample poisons its trial as the scan does (from that sample on
    for onepass, everywhere for twopass); the other trials stay exact; a NaN
    first sample primes onepass with NaN."""
    x = _batch(3, 200, 2, seed=4)
    x[1, 50, 0] = np.nan
    x[2, 0, 1] = np.nan
    sos = pfilt.butter_sos(4, [30.0, 100.0], "bp", FS)
    for got, want in _iir_pairs(x, sos):
        assert np.array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(got[1, 60:, 0]).all() and np.isnan(got[2, :, 1]).all()
        assert np.isfinite(got[0]).all()
        assert _rel_err(got, want) <= IIR_TOL


def test_plain_cascade_sharp_lowpass():
    sos = pfilt.butter_sos(4, 2.0, "lp", FS)
    for got, want in _iir_pairs(_batch(2, 2000, 2, seed=5), sos):
        assert _rel_err(got, want) <= SHARP_IIR_TOL


def test_wrapper_takes_the_plain_version_on_the_cpu():
    x = torch.from_numpy(_batch(2, 120, 3, seed=6, dtype=np.float32))
    sos = pfilt.butter_sos(4, [30.0, 100.0], "bp", FS)
    before = ik.sosfilt_batch.launches
    for twopass in (True, False):
        got = ik.sosfilt_batch(x, sos, twopass)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        assert torch.equal(got, ik.sosfilt_batch_plain(x, sos, twopass))
        assert torch.equal(got, ik.sosfilt_float64_plain(x, sos, twopass).float())
    assert torch.equal(pfilt.sosfiltfilt(sos, x), ik.sosfilt_batch_plain(x, sos, True))
    assert torch.equal(pfilt.sosfilt(sos, x), ik.sosfilt_batch_plain(x, sos, False))
    assert ik.sosfilt_batch.launches == before


def test_wrapper_rejects_what_it_does_not_take():
    sos = pfilt.butter_sos(2, 40.0, "lp", FS)
    with pytest.raises(ValueError):
        ik.sosfilt_batch(torch.zeros((10, 3)), sos)
    with pytest.raises(ValueError):
        ik.sosfilt_batch(torch.zeros((1, 10, 3)), sos[:, :5])


def test_float32_route_matches_jax_within_one_rounding():
    """The routine's route (float32 in, float64 inside, float32 out)
    against the JAX float64 scan rounded the same way."""
    x = _batch(2, 400, 3, seed=11, dtype=np.float32)
    sos = pfilt.butter_sos(4, [30.0, 100.0], "bp", FS)
    got = pfilt.sosfiltfilt(sos, torch.from_numpy(x)).numpy()
    want = _jax_cascades(x.astype(np.float64), sos)[0].astype(np.float32)
    assert got.dtype == want.dtype == np.float32
    assert _rel_err(got, want) <= 1e-6


def test_jax_side_runs_in_float64():
    assert jax.config.jax_enable_x64
