# -*- coding: utf-8 -*-
# Parity tests for the port's host and tensor ops against the JAX package:
# detrend, the taper bank, coherence normalization (every output flavour)
# and the compensated CSD sum. Inputs come from numpy with a seed and go
# through both packages.

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from syncopy_tpu.ops import connectivity as jax_conn
from syncopy_tpu.ops import spectral as jax_spectral
from syncopy_tpu.ops import windows as jax_windows
from syncopy_tpu.shared.input_processors import process_taper as jax_process_taper
from syncopy_tpu_torch.connectivity.connectivity_analysis import connectivity_outputs
from syncopy_tpu_torch.ops import connectivity as conn
from syncopy_tpu_torch.ops import spectral
from syncopy_tpu_torch.ops import windows
from syncopy_tpu_torch.shared.input_processors import process_taper

torch.set_num_threads(1)


@pytest.mark.parametrize("polyremoval", [None, 0, 1])
def test_detrend_matches_jax(polyremoval):
    rng = np.random.default_rng(1)
    t = np.arange(300, dtype=np.float32)[None, :, None]
    x = (rng.normal(size=(4, 300, 5)) + 0.01 * t + 3.0).astype(np.float32)
    got = spectral.detrend(torch.from_numpy(x), polyremoval, dim=1).numpy()
    want = np.asarray(jax_spectral.detrend(jnp.asarray(x), polyremoval, axis=1))
    assert got.dtype == np.float32
    assert np.abs(got - want).max() < 1e-6 * max(1.0, np.abs(want).max())


def test_detrend_rejects_higher_orders():
    with pytest.raises(ValueError):
        spectral.detrend(torch.zeros(3, 4), 2)


@pytest.mark.parametrize("taper, taper_opt, length, pad", [
    ("dpss", {"NW": 2.0, "Kmax": 3}, 1000, 1000),
    ("dpss", {"NW": 1.0, "Kmax": 1}, 250, 250),
    ("hann", {}, 500, 512),
    ("boxcar", {}, 333, 400),
    ("kaiser", {"beta": 3.0}, 128, 128),
])
def test_make_tapers_bit_identical(taper, taper_opt, length, pad):
    got = windows.make_tapers(taper, taper_opt, length, pad, 1000.0)
    want = jax_windows.make_tapers(taper, taper_opt, length, pad, 1000.0)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("tapsmofrq, n_samples", [(2, 1000), (4, 250), (None, 500)])
def test_process_taper_matches_jax(tapsmofrq, n_samples):
    kw = dict(keeptapers=False, foimax=500.0, samplerate=1000.0, nSamples=n_samples,
              output="pow")
    assert (process_taper("hann", None, tapsmofrq, None, **kw)
            == jax_process_taper("hann", None, tapsmofrq, None, **kw))


def _avg_csd(F, C, seed):
    """A trial-averaged CSD with some weak coherences (small |C|)."""
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(30, F, C)) + 1j * rng.normal(size=(30, F, C))
    s[..., 1] += 2.0 * s[..., 0]
    return (np.einsum("nfi,nfj->fij", s, np.conj(s)) / 30).astype(np.complex64)


@pytest.mark.parametrize("output", connectivity_outputs)
def test_normalize_csd_matches_jax(output):
    csd = _avg_csd(F=9, C=6, seed=2)
    got = conn.normalize_csd(torch.from_numpy(csd), output).numpy()
    want = np.asarray(jax_conn.normalize_csd(jnp.asarray(csd), output))
    assert got.shape == want.shape and got.dtype == want.dtype
    if output == "angle":
        coh = np.abs(np.asarray(jax_conn.normalize_csd(jnp.asarray(csd), "abs")))
        keep = coh > 1e-3
        diff = np.angle(np.exp(1j * (got[keep] - want[keep])))  # wrap at +-pi
        assert np.abs(diff).max() < 1e-6
    else:
        assert np.abs(got - want).max() < 1e-6


@pytest.mark.parametrize("output", ["absreal", "absimag"])
def test_spectral_convert_extra_flavours(output):
    z = _avg_csd(F=3, C=4, seed=3)
    got = spectral.spectral_convert(torch.from_numpy(z), output).numpy()
    want = np.asarray(jax_spectral.spectral_convert(jnp.asarray(z), output))
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_csd_sum_compensated_matches_jax():
    rng = np.random.default_rng(4)
    B, K, F, C = 13, 3, 11, 7
    spec = (rng.normal(size=(B, K, F, C)) + 1j * rng.normal(size=(B, K, F, C))).astype(np.complex64)
    got = conn.csd_sum_compensated(torch.from_numpy(spec)).numpy()
    want = np.asarray(jax_conn.csd_sum_compensated(jnp.asarray(spec)))
    oracle = np.einsum("bkfi,bkfj->fij", spec.astype(np.complex128), np.conj(spec))
    scale = np.abs(oracle).max()
    assert got.dtype == np.complex64
    assert np.abs(got - oracle).max() / scale < 1e-6
    assert np.abs(got - want).max() / scale < 1e-6
