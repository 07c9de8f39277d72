# -*- coding: utf-8 -*-
# Card-only tests of the port: the CUDA kernels (tiled and untiled CSD,
# PPC resultant, Butterworth cascade, Wilson's solve) against oracles and
# their plain versions, and the coherence, PPC, Granger, jackknife, corr,
# trial-statistics, freqanalysis, preprocessing and resampling paths on
# the card against the same paths on the CPU; the device AR(2) generator
# against float64, a .spy round trip of a coherence computed through
# the kernel (where h5py is installed), the resident band-pass, resample
# and coherence chain, the trial store's cached timelock upload, and each
# kernel launched on a second card (two cards needed). They skip where no CUDA
# device is present (the kernels have no CPU mode). This file imports no jax, so on a
# machine without it run: python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

import warnings

import numpy as np
import pytest
import torch

import syncopy_tpu_torch as spt
from syncopy_tpu_torch.engine import routine
from syncopy_tpu_torch.ops import csd_kernels as ck
from syncopy_tpu_torch.ops import iir_kernels as ik
from syncopy_tpu_torch.ops import ppc_kernels as pk
from syncopy_tpu_torch.ops import wilson_kernels as wk

torch.set_num_threads(1)

#: max|got - oracle| / max|oracle|
REL_TOL = 1e-5

#: (N, F, C, n_valid, NaN rows past n_valid): block-unaligned shapes,
#: more channels than one 32-wide tile, more rows than one 256-row group
CASES = [(111, 101, 24, 87, False), (40, 17, 8, 25, True), (3, 2, 4, 3, False),
         (600, 5, 70, 555, True)]


@pytest.fixture
def cuda_device():
    """The card, decided at run time: the CUDA kernel has no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _spec(*shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def _ragged_analog(seed, scale=1.0):
    lens = [400] * 9 + [300] * 4
    rng = np.random.default_rng(seed)
    data = (rng.normal(size=(sum(lens), 6)) * scale).astype(np.float32)
    trl = np.zeros((len(lens), 3))
    trl[:, 1] = np.cumsum(lens)
    trl[1:, 0] = trl[:-1, 1]
    return spt.from_arrays(data, trl, 1000.0)


@pytest.mark.cuda
@pytest.mark.parametrize("N, F, C, nv, nan_rows", CASES)
def test_kernel_matches_oracle_and_plain(cuda_device, N, F, C, nv, nan_rows):
    spec = _spec(N, F, C, seed=N)
    rows = spec[:nv].astype(np.complex128)
    want = np.einsum("nfi,nfj->fij", rows, np.conj(rows))
    if nan_rows:
        spec[nv:] = np.nan
    dev = torch.from_numpy(spec).to(cuda_device)
    before = ck.csd_accumulate_tiled.launches
    got = ck.csd_accumulate_tiled(dev, nv)
    plain = ck.csd_accumulate_tiled_plain(dev, nv)
    torch.cuda.synchronize()
    assert ck.csd_accumulate_tiled.launches == before + 1
    got, plain = got.cpu().numpy(), plain.cpu().numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < REL_TOL
    assert np.abs(got - plain).max() / scale < REL_TOL
    assert np.array_equal(got, np.conj(np.swapaxes(got, 1, 2)))


@pytest.mark.cuda
def test_kernel_zero_valid_rows(cuda_device):
    spec = torch.full((3, 2, 4), float("nan"), dtype=torch.complex64, device=cuda_device)
    assert bool((ck.csd_accumulate_tiled(spec, 0) == 0).all())


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    spec = torch.zeros((4, 3, 2), dtype=torch.complex64, device=cuda_device)
    with pytest.raises(TypeError):
        ck.csd_accumulate_tiled(spec.to(torch.complex128), 2)
    with pytest.raises(ValueError):
        ck.csd_accumulate_tiled(spec.transpose(0, 1), 2)


@pytest.mark.cuda
def test_coherence_on_card_matches_cpu(cuda_device, monkeypatch):
    """The main path on the card (multi-chunk, ragged) against the same
    path on the CPU, where the kernel's plain version runs."""
    adata = _ragged_analog(3)
    monkeypatch.setattr(routine, "DEFAULT_CHUNK_BUDGET", 4 * 400 * 6 * 4 * 2)
    ck.csd_accumulate_tiled.launches = 0
    got = np.asarray(spt.connectivityanalysis(adata, method="coh", tapsmofrq=4).data)
    assert ck.csd_accumulate_tiled.launches == 3 + 1  # 9 trials in chunks of 4, 4 in one
    spt.set_device("cpu")
    try:
        want = np.asarray(spt.connectivityanalysis(adata, method="coh", tapsmofrq=4).data)
    finally:
        spt.set_device("cuda:0")
    assert np.abs(got - want).max() < 1e-5


#: (N, F, C, n_valid): the staging ring at its edges. n_valid ends inside a
#: 32-row stage and off the 3-stage ring, with NaN rows behind it; odd C
#: (33, 65) and C = 70 put some rows' chunks off 16-byte alignment; C = 1
#: leaves one valid channel of one chunk; 300 and 513 cross a 256-row group
STAGE_EDGES = [(64, 5, 33, 37), (320, 3, 70, 301), (50, 4, 1, 49), (530, 2, 65, 513),
               (40, 3, 64, 17)]


@pytest.mark.cuda
@pytest.mark.parametrize("N, F, C, nv", STAGE_EDGES)
def test_kernel_stage_edges_and_odd_channels(cuda_device, N, F, C, nv):
    spec = _spec(N, F, C, seed=N + C)
    rows = spec[:nv].astype(np.complex128)
    want = np.einsum("nfi,nfj->fij", rows, np.conj(rows))
    spec[nv:] = np.nan  # the padding the kernel must never read
    got = ck.csd_accumulate_tiled(torch.from_numpy(spec).to(cuda_device), nv).cpu().numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() / np.abs(want).max() < REL_TOL
    assert np.array_equal(got, np.conj(np.swapaxes(got, 1, 2)))
    assert np.all(np.diagonal(got, axis1=1, axis2=2).imag == 0)


@pytest.mark.cuda
def test_kernel_bitwise_deterministic(cuda_device):
    dev = torch.from_numpy(_spec(600, 5, 70, seed=5)).to(cuda_device)
    dev[555:] = float("nan")
    assert torch.equal(ck.csd_accumulate_tiled(dev, 555), ck.csd_accumulate_tiled(dev, 555))


# -- the untiled csd_accumulate ---------------------------------------------- #

#: (F, N, C): test_connectivity.py's case, the pallas_supported() probe,
#: more channels than one tile and more rows than one 256-row group
UNTILED = [(5, 12, 8), (1, 8, 128), (17, 600, 70)]


@pytest.mark.cuda
@pytest.mark.parametrize("F, N, C", UNTILED)
def test_untiled_kernel_matches_oracle_and_plain(cuda_device, F, N, C):
    spec = _spec(F, N, C, seed=F + N)
    want = np.einsum("fni,fnj->fij", spec.astype(np.complex128), np.conj(spec.astype(np.complex128)))
    re = torch.from_numpy(spec.real.copy()).to(cuda_device)
    im = torch.from_numpy(spec.imag.copy()).to(cuda_device)
    before = ck.csd_accumulate.launches
    got_re, got_im = ck.csd_accumulate(re, im)
    plain_re, plain_im = ck.csd_accumulate_plain(re, im)
    torch.cuda.synchronize()
    assert ck.csd_accumulate.launches == before + 1
    got = got_re.cpu().numpy() + 1j * got_im.cpu().numpy()
    plain = plain_re.cpu().numpy() + 1j * plain_im.cpu().numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < REL_TOL
    assert np.abs(plain - want).max() / scale < REL_TOL
    assert np.array_equal(got, np.conj(np.swapaxes(got, 1, 2)))


#: (F, N, C): N off the stage and the ring, odd and unaligned C (see
#: STAGE_EDGES), one channel, N across a 256-row group
UNTILED_EDGES = [(3, 37, 33), (2, 301, 70), (4, 49, 1), (2, 513, 65), (3, 17, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("F, N, C", UNTILED_EDGES)
def test_untiled_kernel_stage_edges_and_odd_channels(cuda_device, F, N, C):
    spec = _spec(F, N, C, seed=F * N + C)
    z = spec.astype(np.complex128)
    want = np.einsum("fni,fnj->fij", z, np.conj(z))
    re = torch.from_numpy(spec.real.copy()).to(cuda_device)
    im = torch.from_numpy(spec.imag.copy()).to(cuda_device)
    got_re, got_im = ck.csd_accumulate(re, im)
    got = got_re.cpu().numpy() + 1j * got_im.cpu().numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < REL_TOL
    assert np.array_equal(got, np.conj(np.swapaxes(got, 1, 2)))
    assert not got_im.cpu()[:, torch.arange(C), torch.arange(C)].any()


@pytest.mark.cuda
def test_untiled_kernel_bitwise_deterministic(cuda_device):
    spec = _spec(5, 600, 70, seed=6)
    re = torch.from_numpy(spec.real.copy()).to(cuda_device)
    im = torch.from_numpy(spec.imag.copy()).to(cuda_device)
    first, second = ck.csd_accumulate(re, im), ck.csd_accumulate(re, im)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.cuda
def test_untiled_kernel_single_row(cuda_device):
    one = torch.zeros((2, 1, 4), device=cuda_device)
    one[0, 0, 1] = 2.0
    cs_re, cs_im = ck.csd_accumulate(one, torch.zeros_like(one))
    want = torch.zeros((2, 4, 4))
    want[0, 1, 1] = 4.0
    assert torch.equal(cs_re.cpu(), want) and not cs_im.any()


@pytest.mark.cuda
def test_untiled_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros((3, 4, 2), device=cuda_device)
    with pytest.raises(TypeError):
        ck.csd_accumulate(x.double(), x.double())
    with pytest.raises(ValueError):
        ck.csd_accumulate(x.transpose(0, 1), x.transpose(0, 1))
    with pytest.raises(ValueError):
        ck.csd_accumulate(x, x.cpu())


# -- the PPC resultant ------------------------------------------------------- #

#: (N, K, F, C, n_valid, NaN trials past n_valid): block-unaligned, full
#: count, NaN padding, three channel tiles with K = 5, K = 1
PPC_CASES = [(21, 3, 11, 8, 17, False), (16, 2, 8, 4, 16, False), (13, 2, 9, 6, 9, True),
             (37, 5, 7, 70, 30, True), (9, 1, 4, 33, 9, False)]


def _ppc_oracle(spec, n_valid):
    s = spec[:n_valid].astype(np.complex128)
    csd = np.einsum("nkfi,nkfj->nfij", s, np.conj(s))
    mag = np.abs(csd)
    return np.where(mag > 0, csd / np.where(mag > 0, mag, 1.0), 0.0).sum(axis=0)


@pytest.mark.cuda
@pytest.mark.parametrize("N, K, F, C, nv, nan_trials", PPC_CASES)
def test_ppc_kernel_matches_oracle_and_plain(cuda_device, N, K, F, C, nv, nan_trials):
    spec = _spec(N, K, F, C, seed=N + C)
    want = _ppc_oracle(spec, nv)
    if nan_trials:
        spec[nv:] = np.nan
    dev = torch.from_numpy(spec).to(cuda_device)
    before = pk.ppc_accumulate_tiled.launches
    got = pk.ppc_accumulate_tiled(dev, nv)
    plain = pk.ppc_accumulate_tiled_plain(dev, nv)
    torch.cuda.synchronize()
    assert pk.ppc_accumulate_tiled.launches == before + 1
    got, plain = got.cpu().numpy(), plain.cpu().numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() / nv < REL_TOL
    assert np.abs(plain - want).max() / nv < REL_TOL
    diag = got[:, np.arange(C), np.arange(C)]
    assert np.allclose(diag.real, nv, atol=1e-3) and np.all(diag.imag == 0)
    assert np.array_equal(got, np.conj(np.swapaxes(got, 1, 2)))


@pytest.mark.cuda
def test_ppc_kernel_zero_trials_and_zero_bins(cuda_device):
    spec = torch.full((4, 1, 3, 4), float("nan"), dtype=torch.complex64, device=cuda_device)
    assert bool((pk.ppc_accumulate_tiled(spec, 0) == 0).all())
    spec = torch.from_numpy(_spec(6, 2, 5, 3, seed=2))
    spec[:, :, 1] = 0
    got = pk.ppc_accumulate_tiled(spec.to(cuda_device), 6).cpu()
    assert bool(torch.isfinite(got).all()) and bool((got[1] == 0).all())


@pytest.mark.cuda
def test_ppc_kernel_rejects_what_it_does_not_take(cuda_device):
    spec = torch.zeros((4, 2, 3, 2), dtype=torch.complex64, device=cuda_device)
    with pytest.raises(TypeError):
        pk.ppc_accumulate_tiled(spec.to(torch.complex128), 2)
    with pytest.raises(ValueError):
        pk.ppc_accumulate_tiled(spec.transpose(2, 3), 2)
    with pytest.raises(ValueError):
        pk.ppc_accumulate_tiled(spec, 5)
    with pytest.raises(ValueError):
        pk.ppc_accumulate_tiled(spec[0], 1)


@pytest.mark.cuda
def test_ppc_on_card_matches_cpu(cuda_device, monkeypatch):
    """method="ppc" on the card (multi-chunk, ragged) against the same
    call on the CPU, where the kernel's plain version runs; also on the
    same data x 1e-13 (MEG in tesla), where a phasor formed from unscaled
    squares drops every term."""
    monkeypatch.setattr(routine, "DEFAULT_CHUNK_BUDGET", 4 * 400 * 6 * 4 * 2)
    for scale in (1.0, 1e-13):
        adata = _ragged_analog(4, scale)
        pk.ppc_accumulate_tiled.launches = 0
        got = np.asarray(spt.connectivityanalysis(adata, method="ppc", tapsmofrq=4).data)
        assert pk.ppc_accumulate_tiled.launches == 3 + 1  # 9 trials in chunks of 4, 4 in one
        spt.set_device("cpu")
        try:
            want = np.asarray(spt.connectivityanalysis(adata, method="ppc", tapsmofrq=4).data)
        finally:
            spt.set_device("cuda:0")
        assert np.abs(got - want).max() < 1e-5


#: (N, K, F, C, n_valid): every compile-time K (1..8 staged as whole
#: trials) and the run-time-K instance (9, and 20, whose trials span
#: stages), C at and around the 32-wide tile (1, 31, 32, 33, 64, 65, 128),
#: n_valid ending inside a stage; NaN trials behind it
PPC_EDGES = [(40, 1, 3, 1, 37), (36, 2, 3, 31, 33), (25, 3, 4, 32, 23), (20, 4, 3, 33, 19),
             (18, 7, 2, 64, 17), (15, 9, 2, 65, 13), (9, 20, 2, 128, 8), (13, 3, 2, 128, 12),
             (21, 5, 2, 65, 20), (17, 6, 2, 33, 15), (14, 8, 2, 40, 11)]


def _ppc_case(cuda_device, N, K, F, C, nv, scale, seed):
    spec = (_spec(N, K, F, C, seed=seed) * np.float32(scale)).astype(np.complex64)
    want = _ppc_oracle(spec, nv)
    spec[nv:] = np.nan
    dev = torch.from_numpy(spec).to(cuda_device)
    got = pk.ppc_accumulate_tiled(dev, nv)
    plain = pk.ppc_accumulate_tiled_plain(dev, nv)
    return got.cpu().numpy(), plain.cpu().numpy(), want


@pytest.mark.cuda
@pytest.mark.parametrize("N, K, F, C, nv", PPC_EDGES)
def test_ppc_kernel_stage_edges_channels_and_tapers(cuda_device, N, K, F, C, nv):
    got, plain, want = _ppc_case(cuda_device, N, K, F, C, nv, 1.0, seed=N * K + C)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() / nv < REL_TOL
    assert np.abs(plain - want).max() / nv < REL_TOL
    diag = np.diagonal(got, axis1=1, axis2=2)
    assert np.all(diag.real == nv) and np.all(diag.imag == 0)
    assert np.array_equal(got, np.conj(np.swapaxes(got, 1, 2)))


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1e-13, 1e-18, 1e10])
def test_ppc_kernel_exact_at_every_scale(cuda_device, scale):
    """The unit phasor does not depend on the spectrum's scale: at 1e-13
    and 1e-18 |csd|^2 underflows float32, at 1e10 it overflows."""
    got, plain, want = _ppc_case(cuda_device, 21, 3, 5, 33, 19, scale, seed=9)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() / 19 < REL_TOL
    assert np.abs(plain - want).max() / 19 < REL_TOL
    assert np.all(np.diagonal(got, axis1=1, axis2=2) == 19)


@pytest.mark.cuda
def test_ppc_kernel_finite_on_denormal_cross_spectra(cuda_device):
    got, plain, _ = _ppc_case(cuda_device, 21, 3, 5, 33, 19, 1e-20, seed=9)
    assert np.isfinite(got).all() and np.isfinite(plain).all()
    assert np.all(np.diagonal(got, axis1=1, axis2=2) == 19)


@pytest.mark.cuda
def test_ppc_kernel_bitwise_deterministic(cuda_device):
    dev = torch.from_numpy(_spec(50, 3, 5, 70, seed=5)).to(cuda_device)
    dev[45:] = float("nan")
    assert torch.equal(pk.ppc_accumulate_tiled(dev, 45), pk.ppc_accumulate_tiled(dev, 45))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [3, 9])
def test_ppc_kernel_occupancy(cuda_device, K):
    threads, blocks = pk.kernel_occupancy(K)
    assert threads == 128 and blocks >= 1


def _ar2_network(n_chan, n_trials, n_samples, seed):
    """(trials, samples, channels) float64 AR(2) network (a spectral peak
    at 0.2 of the sampling rate) in which channel 1 drives channel 0."""
    rng = np.random.default_rng(seed)
    m1 = np.diag(np.full(n_chan, 0.55))
    m1[0, 1] = 0.25
    x = rng.normal(size=(n_trials, n_samples, n_chan))
    for t in range(2, n_samples):
        x[:, t] += x[:, t - 1] @ m1.T - 0.8 * x[:, t - 2]
    return x


def _ar2_spectra(n_chan, n_trials, n_samples, seed):
    """(trials, 1, F, channels) complex64 hann spectra (demeaned taper) of
    :func:`_ar2_network`, and the trialdefinition of one spectrum a trial."""
    x = _ar2_network(n_chan, n_trials, n_samples, seed)
    tapered = np.hanning(n_samples)[None, :, None] * (x - x.mean(axis=1, keepdims=True))
    tapered -= tapered.mean(axis=1, keepdims=True)
    spec = np.fft.rfft(tapered, axis=1)[:, None].astype(np.complex64)
    trl = np.array([[k, k + 1, 0] for k in range(n_trials)])
    return spec, trl


@pytest.mark.cuda
def test_granger_on_card_matches_cpu(cuda_device):
    """method="granger" from the same spectra on the card and on the CPU:
    G within 1e-6, equal diagnostics; the factorization of one CSD on
    both stops at the same step. (From AnalogData the two devices' DC
    bins hold different float64 rounding noise, which moves G by ~1e-3:
    tests/test_torch_granger.py::test_granger_moves_with_the_dc_rounding_noise.)"""
    from syncopy_tpu_torch.ops import connectivity as pc

    spec, trl = _ar2_spectra(4, 60, 200, seed=21)
    freq = np.fft.rfftfreq(200, 1 / 200.0)
    sdata = spt.SpectralData(data=spec, samplerate=200.0, freq=freq, trialdefinition=trl)
    launches = [ck.csd_accumulate_tiled.launches, ck.csd_accumulate.launches,
                pk.ppc_accumulate_tiled.launches]
    out = spt.connectivityanalysis(sdata, method="granger")
    assert [ck.csd_accumulate_tiled.launches, ck.csd_accumulate.launches,
            pk.ppc_accumulate_tiled.launches] == launches  # no kernel on this path
    spt.set_device("cpu")
    try:
        ref = spt.connectivityanalysis(sdata, method="granger")
    finally:
        spt.set_device("cuda:0")
    got, want = np.asarray(out.data), np.asarray(ref.data)
    assert np.isfinite(got).all() and np.abs(got - want).max() < 1e-6
    assert out.info["converged"] and ref.info["converged"]
    assert out.info["reg. factor"] == ref.info["reg. factor"]
    assert "host float64" not in out.log
    f40 = np.argmin(np.abs(freq - 40))
    assert got[0, f40, 1, 0] > 0.3 and got[0, f40, 0, 1] < 0.1

    s = spec[:, 0].astype(np.complex128)
    csd = torch.from_numpy(np.einsum("bfi,bfj->fij", s, s.conj()) / len(s))
    runs = []
    for device in (cuda_device, torch.device("cpu")):
        C = pc.regularize_csd(csd.to(device), cond_max=1e4, eps_max=1e-1)[0]
        H, Sigma, conv, err, n_iter = pc.wilson_sf(C, nIter=100, rtol=5e-6)
        runs.append((H.cpu().numpy(), bool(conv), int(n_iter)))
    (H_card, conv_card, n_card), (H_cpu, conv_cpu, n_cpu) = runs
    assert conv_card == conv_cpu and n_card == n_cpu
    assert np.abs(H_card - H_cpu).max() / np.abs(H_cpu).max() < 1e-8


@pytest.mark.cuda
def test_granger_from_analog_data_on_card(cuda_device):
    """The float64 CSD stage and the device factorization from AnalogData:
    converged, no host path, the direction of the drive."""
    x = _ar2_network(4, 60, 200, seed=22).astype(np.float32)
    trl = np.array([[k * 200, (k + 1) * 200, 0] for k in range(60)])
    adata = spt.from_arrays(x.reshape(-1, 4), trl, 200.0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = spt.connectivityanalysis(adata, method="granger")
    assert not [w for w in caught if "host float64" in str(w.message)]
    G = np.asarray(out.data)
    assert G.shape == (1, 101, 4, 4) and np.isfinite(G).all()
    assert out.info["converged"] and out.info["max rel. err"] < 5e-6
    f40 = np.argmin(np.abs(out.freq - 40))
    assert G[0, f40, 1, 0] > 0.3 and G[0, f40, 0, 1] < 0.1


@pytest.mark.cuda
def test_singular_inputs_give_nan_on_card(cuda_device):
    """A CSD bin without a Cholesky factor and a singular psi take the
    NaN-safe path through cholesky_ex / inv_ex: no exception, no host
    sync to check them, NaN where the JAX package gives NaN."""
    from syncopy_tpu_torch.ops import connectivity as pc

    spec, _ = _ar2_spectra(3, 30, 64, seed=24)
    s = torch.from_numpy(spec[:, 0]).to(cuda_device, torch.complex128)
    C = torch.einsum("bfi,bfj->fij", s, s.conj()) / len(s)
    C[4] = -C[4]
    H, Sigma, conv, err, n_iter = pc.wilson_sf(C, nIter=20, rtol=5e-6)
    assert not bool(conv) and bool(torch.isnan(err)) and int(n_iter) == 1
    assert bool(pc._inv_nan(torch.zeros((2, 3, 3), dtype=torch.complex128,
                                        device=cuda_device)).isnan().all())
    lo, hi, _ = pc.csd_lam_extents(C[None])
    assert bool(torch.isfinite(lo).all()) and bool((lo <= hi).all())
    assert bool((lo[0, 4] < 0))  # the negated bin's smallest eigenvalue


#: (batch shape, N) of the Wilson solve: the benchmark's step (501 bins of
#: 128 channels) and its two-sided retry (1000), jackknife replicates,
#: pairwise Granger, the widest N, both instances' edges and odd N
WILSON_SOLVE_CASES = [((501,), 128), ((1000,), 128), ((3, 501), 16), ((4096,), 2),
                      ((64,), 256), ((40,), 33), ((40,), 127), ((5,), 1), ((9,), 17),
                      ((9,), 32), ((9,), 64)]


def _solve_inputs(lead, n, device, seed, diagonal=True):
    """(*lead, n, n) complex128 psi and U drawn on `device`; psi diagonally
    loaded, or with its whole diagonal zero (`diagonal=False`)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = lambda: torch.randn(lead + (n, n), dtype=torch.complex128, device=device,  # noqa: E731
                               generator=gen)
    psi, U = draw(), draw()
    eye = torch.eye(n, dtype=torch.bool, device=device)
    psi = psi + 2 * n ** 0.5 * eye if diagonal else psi.masked_fill(eye, 0)
    return psi, U


def _solve_check(psi, U):
    """The kernel against its plain version on the card: relative to the
    largest |X|, 1e-9 (two FP64 solves of well-conditioned systems that
    round apart); one launch."""
    before = wk.wilson_solve.launches
    got = wk.wilson_solve(psi, U)
    want = wk.wilson_solve_plain(psi, U)
    torch.cuda.synchronize()
    assert wk.wilson_solve.launches == before + 1
    assert got.shape == U.shape and got.dtype == torch.complex128
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max() / want.abs().max()) < 1e-9
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("lead, n", WILSON_SOLVE_CASES)
def test_wilson_solve_matches_plain(cuda_device, lead, n):
    _solve_check(*_solve_inputs(lead, n, cuda_device, seed=n))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5, 16, 40, 128])
def test_wilson_solve_pivots_past_a_zero_diagonal(cuda_device, n):
    """Every diagonal entry of psi zero: no step can take its diagonal as
    the pivot (n = 1 is singular and must give NaN)."""
    psi, U = _solve_inputs((7,), n, cuda_device, seed=100 + n, diagonal=False)
    if n == 1:
        assert bool(wk.wilson_solve(psi, U).isnan().all())
        return
    X = _solve_check(psi, U)
    assert float((psi @ X - U).abs().max() / U.abs().max()) < 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 16, 33, 128])
def test_wilson_solve_singular_bin_gives_nan_there_only(cuda_device, n):
    psi, U = _solve_inputs((6,), n, cuda_device, seed=200 + n)
    psi[4, :, n // 2] = 0  # an exactly zero pivot in column n // 2
    got = wk.wilson_solve(psi, U)
    want = wk.wilson_solve_plain(psi, U)
    assert bool(got[4].isnan().all()) and bool(want[4].isnan().all())
    keep = [0, 1, 2, 3, 5]
    assert bool(torch.isfinite(got[keep]).all())
    assert float((got[keep] - want[keep]).abs().max() / want[keep].abs().max()) < 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("lead, n", [((501,), 128), ((64,), 7)])
def test_wilson_solve_bitwise_deterministic(cuda_device, lead, n):
    psi, U = _solve_inputs(lead, n, cuda_device, seed=7)
    assert torch.equal(wk.wilson_solve(psi, U), wk.wilson_solve(psi, U))


@pytest.mark.cuda
def test_wilson_solve_rejects_what_it_does_not_take(cuda_device):
    psi, U = _solve_inputs((2,), 257, cuda_device, seed=1)
    with pytest.raises(ValueError, match="channels"):
        wk.wilson_solve(psi, U)
    psi, U = _solve_inputs((2,), 8, cuda_device, seed=2)
    with pytest.raises(TypeError, match="complex128"):
        wk.wilson_solve(psi.to(torch.complex64), U.to(torch.complex64))
    with pytest.raises(ValueError, match="contiguous"):
        wk.wilson_solve(psi.mT, U)
    with pytest.raises(ValueError, match="one shape"):
        wk.wilson_solve(psi, U[:1])


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["one_sided", "two_sided"])
def test_wilson_steps_take_the_solve_kernel(cuda_device, form):
    """Every step of a Wilson loop on the card launches the kernel once and
    inv_ex never; H against the CPU factorization of the same CSD."""
    from syncopy_tpu_torch.ops import connectivity as pc

    wilson = pc.wilson_sf if form == "one_sided" else pc.wilson_sf_twosided
    spec, _ = _ar2_spectra(8, 60, 200, seed=25)
    s = spec[:, 0].astype(np.complex128)
    csd = torch.from_numpy(np.einsum("bfi,bfj->fij", s, s.conj()) / len(s))
    C = pc.regularize_csd(csd, cond_max=1e4, eps_max=1e-1)[0]
    pc.reset_wilson_counts()
    before = wk.wilson_solve.launches
    H, Sigma, conv, err, n_iter = wilson(C.to(cuda_device), nIter=100, rtol=5e-6)
    counts = pc.wilson_counts()
    steps = counts[form + "_steps"]
    assert bool(conv) and steps == int(n_iter) > 1
    assert counts["solve_kernel"] == steps and counts["solve_library"] == 0
    assert wk.wilson_solve.launches == before + steps
    H_cpu = wilson(C, nIter=100, rtol=5e-6)[0]
    assert pc.wilson_counts()["solve_library"] == int(n_iter)
    assert float((H.cpu() - H_cpu).abs().max() / H_cpu.abs().max()) < 1e-8


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 128])
def test_wilson_solve_launches_on_every_card(cuda_device, n):
    """At N = 128 a block takes more than the default 48 KB of shared
    memory, an attribute the runtime keeps per card: the kernel launches
    on every visible card in turn and then on the first again, each time
    with another card current, and agrees with its plain version there."""
    cards = torch.cuda.device_count()
    for k in [*range(cards), 0]:
        dev = torch.device("cuda", k)
        psi, U = _solve_inputs((3,), n, dev, seed=k)
        with torch.cuda.device(cards - 1 - k):
            X = _solve_check(psi, U)
        assert X.device == dev


def _equal_analog(seed, n_trials=9, n_samples=400, n_chan=6):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n_trials * n_samples, n_chan)).astype(np.float32)
    trl = np.array([[k * n_samples, (k + 1) * n_samples, 0] for k in range(n_trials)])
    return spt.from_arrays(data, trl, 1000.0)


def _on_both_devices(call):
    """`call()` on the card, then on the CPU; the card stays the setting."""
    on_card = call()
    spt.set_device("cpu")
    try:
        on_cpu = call()
    finally:
        spt.set_device("cuda:0")
    return on_card, on_cpu


@pytest.mark.cuda
def test_coh_jackknife_on_card_matches_cpu(cuda_device):
    """Coherence with jackknife error bars: the same call on the card and
    on the CPU, the coherence and both datasets within 1e-5, no kernel
    launched (the single-trial CSDs are one batched matmul a chunk)."""
    adata = _equal_analog(31)
    launches = [ck.csd_accumulate_tiled.launches, pk.ppc_accumulate_tiled.launches]
    out, ref = _on_both_devices(lambda: spt.connectivityanalysis(
        adata, method="coh", tapsmofrq=4, jackknife=True))
    assert [ck.csd_accumulate_tiled.launches, pk.ppc_accumulate_tiled.launches] == [
        launches[0], launches[1]]
    for get in (lambda o: o.data, lambda o: o._get_extra_dataset("jack_var"),
                lambda o: o._get_extra_dataset("jack_bias")):
        got, want = np.asarray(get(out)), np.asarray(get(ref))
        assert got.dtype == want.dtype == np.float32 and np.isfinite(got).all()
        assert np.abs(got - want).max() < 1e-5


@pytest.mark.cuda
def test_granger_jackknife_on_card_matches_cpu(cuda_device):
    """Granger with jackknife error bars from the same spectra on the card
    and on the CPU: G and the datasets within 1e-5, every replicate on the
    device route."""
    spec, trl = _ar2_spectra(3, 40, 200, seed=25)
    freq = np.fft.rfftfreq(200, 1 / 200.0)
    sdata = spt.SpectralData(data=spec, samplerate=200.0, freq=freq, trialdefinition=trl)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out, ref = _on_both_devices(lambda: spt.connectivityanalysis(
            sdata, method="granger", jackknife=True))
    assert not [w for w in caught if "host float64" in str(w.message)]
    assert out.info["converged"] and ref.info["converged"]
    for get in (lambda o: o.data, lambda o: o._get_extra_dataset("jack_var"),
                lambda o: o._get_extra_dataset("jack_bias")):
        got, want = np.asarray(get(out)), np.asarray(get(ref))
        assert np.isfinite(got).all() and np.abs(got - want).max() < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("keeptrials", [False, True])
def test_corr_on_card_matches_cpu(cuda_device, keeptrials):
    adata = _equal_analog(26, n_trials=12, n_samples=64, n_chan=5)
    out, ref = _on_both_devices(lambda: spt.connectivityanalysis(
        adata, method="corr", keeptrials=keeptrials))
    got, want = np.asarray(out.data), np.asarray(ref.data)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() < 1e-5


@pytest.mark.cuda
def test_trial_statistics_on_card_match_cpu(cuda_device):
    adata = _equal_analog(27)
    for op in ("mean", "var", "std"):
        out, ref = _on_both_devices(lambda: getattr(spt, op)(adata, dim="trials"))
        assert np.abs(np.asarray(out.data) - np.asarray(ref.data)).max() < 1e-6


#: freqanalysis calls of each method at small sizes, on ragged trials where
#: the method allows them
FREQANALYSIS_CASES = [
    dict(method="mtmfft", tapsmofrq=4, output="fourier", keeptapers=True),
    dict(method="mtmfft", output="pow", keeptrials=False, exact_fft=True),
    dict(method="mtmconvol", t_ftimwin=0.101, toi=np.array([0.0, 0.05, 0.3, 0.4])),
    dict(method="welch", t_ftimwin=0.064, toi=0.5, tapsmofrq=40),
    dict(method="wavelet", foi=[15.0, 40.0, 90.0, 200.0], output="fourier"),
    dict(method="superlet", order_max=4, foi=[15.0, 40.0, 90.0, 200.0]),
    dict(method="superlet", order_max=3, adaptive=True, foi=[15.0, 40.0, 90.0],
         output="fourier"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", FREQANALYSIS_CASES)
def test_freqanalysis_on_card_matches_cpu(cuda_device, kw):
    """Each method on the card (cuFFT) against the same call on the CPU,
    within 1e-5 of the CPU result's maximum, with no kernel launched."""
    adata = _ragged_analog(28) if kw["method"] != "mtmfft" or kw.get("keeptrials", True) \
        else _equal_analog(28)
    launches = [ck.csd_accumulate_tiled.launches, pk.ppc_accumulate_tiled.launches]
    out, ref = _on_both_devices(lambda: spt.freqanalysis(adata, **kw))
    assert [ck.csd_accumulate_tiled.launches, pk.ppc_accumulate_tiled.launches] == launches
    got, want = np.asarray(out.data), np.asarray(ref.data)
    assert got.shape == want.shape and got.dtype == want.dtype and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert np.array_equal(out.trialdefinition, ref.trialdefinition)


# -- the Butterworth cascade (csrc/sosfilt.cu) ------------------------------- #

#: (filter type, order, cut-offs in Hz at 1 kHz)
IIR_DESIGNS = [(ft, order, freq) for order in range(1, 9)
               for ft, freq in (("lp", 40.0), ("hp", 20.0), ("bp", [30.0, 100.0]),
                                ("bs", [45.0, 55.0]))]
#: (N, T, C): the edge lengths (T = 2, 5, 28: padlen cut to T - 1) and
#: channel counts off, on and past a warp
IIR_SHAPES = [(3, 2, 1), (2, 5, 33), (4, 28, 64), (3, 1000, 128), (2, 1000, 33)]


#: the kernel against its plain version: 2 float32 ulps of the maximum (the
#: same float64 arithmetic in the same order, unless the kernel fuses its
#: products into FMAs; each side is rounded once to float32)
IIR_PLAIN_TOL = 2.0 ** -22


def _iir_check(x_np, sos, twopass, cuda_device):
    """The kernel against its plain version on the card, within
    IIR_PLAIN_TOL of the plain version's maximum, and against scipy's
    float64 sosfiltfilt/sosfilt (padlen as the port sets it), within 1e-6
    of scipy's maximum; NaN where scipy gives NaN."""
    from scipy import signal

    x = torch.from_numpy(x_np).to(cuda_device)
    before = ik.sosfilt_batch.launches
    got = ik.sosfilt_batch(x, sos, twopass).cpu().numpy()
    assert ik.sosfilt_batch.launches == before + 1
    plain = ik.sosfilt_batch_plain(x, sos, twopass).cpu().numpy()
    xd = x_np.astype(np.float64)
    if twopass:
        want = signal.sosfiltfilt(sos, xd, axis=1, padlen=ik.sosfilt_padlen(sos, x_np.shape[1]))
    else:
        want = signal.sosfilt(sos, xd, axis=1)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isnan(plain), np.isnan(want))
    ok = ~np.isnan(want)
    scale = np.abs(want[ok]).max()
    assert np.abs(got[ok] - want[ok]).max() <= 1e-6 * scale
    assert np.abs(got[ok] - plain[ok]).max() <= IIR_PLAIN_TOL * np.abs(plain[ok]).max()


@pytest.mark.cuda
@pytest.mark.parametrize("ftype, order, freq", IIR_DESIGNS)
def test_sosfilt_kernel_every_design(cuda_device, ftype, order, freq):
    rng = np.random.default_rng(order)
    x = rng.normal(size=(3, 1000, 33)).astype(np.float32)
    sos = ik_sos(order, freq, ftype)
    for twopass in (True, False):
        _iir_check(x, sos, twopass, cuda_device)


def ik_sos(order, freq, ftype):
    from syncopy_tpu_torch.ops.filtering import butter_sos

    return butter_sos(order, freq, ftype, 1000.0)


@pytest.mark.cuda
@pytest.mark.parametrize("N, T, C", IIR_SHAPES)
@pytest.mark.parametrize("twopass", [True, False])
def test_sosfilt_kernel_edge_shapes_and_nan_trials(cuda_device, N, T, C, twopass):
    rng = np.random.default_rng(T + C)
    x = rng.normal(size=(N, T, C)).astype(np.float32)
    x[1, T // 2, C // 2] = np.nan  # one NaN trial among finite ones
    _iir_check(x, ik_sos(4, [30.0, 100.0], "bp"), twopass, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("n_sections", [1, 2, 3, 4, 5, 6, 7, 8, 10])
@pytest.mark.parametrize("T", [2, 3, 5, 9])
def test_sosfilt_kernel_short_trials_every_instance(cuda_device, n_sections, T):
    """Trials no longer than the sections' wavefront: its prologue and
    epilogue (S - 1 steps each) overlap the whole trial, at every
    compile-time instance and the run-time one (S = 10), with a NaN trial."""
    sos = ik_sos(1, 40.0, "lp") if n_sections == 1 else ik_sos(n_sections, [30.0, 100.0], "bp")
    assert sos.shape[0] == n_sections
    rng = np.random.default_rng(100 * n_sections + T)
    x = rng.normal(size=(3, T, 33)).astype(np.float32)
    x[1, T // 2, 16] = np.nan
    for twopass in (True, False):
        _iir_check(x, sos, twopass, cuda_device)


@pytest.mark.cuda
def test_sosfilt_kernel_run_time_sections(cuda_device):
    """Past the compile-time instances (S > 8): the run-time one."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 600, 40)).astype(np.float32)
    for twopass in (True, False):
        _iir_check(x, ik_sos(10, [60.0, 200.0], "bp"), twopass, cuda_device)


@pytest.mark.cuda
def test_sosfilt_kernel_bitwise_deterministic(cuda_device):
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.normal(size=(5, 700, 64)).astype(np.float32)).to(cuda_device)
    sos = ik_sos(4, [30.0, 100.0], "bp")
    for twopass in (True, False):
        assert torch.equal(ik.sosfilt_batch(x, sos, twopass), ik.sosfilt_batch(x, sos, twopass))


@pytest.mark.cuda
def test_sosfilt_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros((2, 50, 8), device=cuda_device)
    sos = ik_sos(2, 40.0, "lp")
    with pytest.raises(TypeError):
        ik.sosfilt_batch(x.double(), sos)
    with pytest.raises(ValueError):
        ik.sosfilt_batch(x.transpose(1, 2), sos)
    with pytest.raises(ValueError):
        ik.sosfilt_batch(x, np.tile(sos, (65, 1)))


@pytest.mark.cuda
def test_sosfilt_kernel_occupancy(cuda_device):
    """The S = 4 twopass instance fits the main-path shape's one wave: at
    least 4 blocks of 128 threads (16 warps) resident per SM."""
    threads, blocks = ik.kernel_occupancy(4)
    assert threads == 128 and blocks >= 4
    registers, local_bytes = ik.kernel_attributes(4)
    assert registers <= 128 and local_bytes == 0  # no spills


#: preprocessing and resampledata calls at small sizes
PREPROC_CASES = [
    ("preprocessing", dict(filter_class="but", filter_type="bp", freq=[30, 100], order=4)),
    ("preprocessing", dict(filter_class="but", filter_type="hp", freq=20, direction="onepass",
                           polyremoval=1, zscore=True)),
    ("preprocessing", dict(filter_class="firws", filter_type="bp", freq=[8, 12], order=200,
                           hilbert="abs")),
    ("preprocessing", dict(filter_class="firws", filter_type="lp", freq=50, order=100,
                           direction="onepass-minphase", rectify=True)),
    ("resampledata", dict(resamplefs=250, method="resample")),
    ("resampledata", dict(resamplefs=250, method="downsample", lpfreq=100)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("func, kw", PREPROC_CASES)
def test_preprocessing_on_card_matches_cpu(cuda_device, monkeypatch, func, kw):
    """Each route on the card (the IIR kernel, cuFFT) against the same call
    on the CPU (the plain cascade), within 1e-5 of the CPU result's
    maximum; in chunks of 4, the IIR kernel launches once a chunk."""
    from syncopy_tpu_torch.preproc.compRoutines import ButFiltering

    adata = _ragged_analog(29)
    # four 400-sample trials a chunk at the IIR routine's workspace
    per_trial = ButFiltering(samplerate=1000.0, filter_type="bp", freq=[30, 100]
                             ).device_bytes_per_trial((400, 6), None, None)
    monkeypatch.setattr(routine, "DEFAULT_CHUNK_BUDGET", 4 * per_trial + 1)
    ik.sosfilt_batch.launches = 0
    out, ref = _on_both_devices(lambda: getattr(spt, func)(adata, **kw))
    if kw.get("filter_class") == "but":
        assert ik.sosfilt_batch.launches == 3 + 1  # 9 trials in chunks of 4, 4 in one
    got, want = np.asarray(out.data), np.asarray(ref.data)
    assert got.shape == want.shape and got.dtype == want.dtype and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert np.array_equal(out.trialdefinition, ref.trialdefinition)
    assert out.info == ref.info


def _ar2_f64(noise, m1, alpha2):
    """The AR(2) recursion of `noise` in float64."""
    x = noise.double()
    out = torch.empty_like(x)
    out[:, :2] = x[:, :2]
    m1t = m1.double().T
    for t in range(2, x.shape[1]):
        out[:, t] = out[:, t - 1] @ m1t + alpha2 * out[:, t - 2] + x[:, t]
    return out


@pytest.mark.cuda
def test_ar2_network_device_on_card_matches_float64(cuda_device):
    """The generator's output on the card against a float64 recursion of
    the same noise (its torch.Generator drawn again), 1e-5 of the
    maximum; the same seed gives the same bits."""
    from syncopy_tpu_torch.synthdata.analog import ar2_network_device

    adj = np.zeros((8, 8), np.float32)
    adj[1, 0] = 0.25
    previous = spt.set_device(cuda_device)
    try:
        got = ar2_network_device(64, AdjMat=adj, nSamples=300, seed=7)
        again = ar2_network_device(64, AdjMat=adj, nSamples=300, seed=7)
    finally:
        spt.set_device(previous)
    assert got.device.type == "cuda" and got.dtype == torch.float32
    assert torch.equal(got, again)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(7)
    noise = torch.randn((64, 300, 8), generator=gen, dtype=torch.float32, device=cuda_device)
    m1 = torch.from_numpy(np.diag(np.full(8, 0.55, np.float32)) + adj.T).to(cuda_device)
    want = _ar2_f64(noise, m1, -0.8)
    assert (got.double() - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.cuda
def test_coherence_through_the_kernel_round_trips_a_container(cuda_device, tmp_path):
    """A coherence computed through the CSD kernel, saved and loaded:
    bitwise; and the coherence of the loaded AnalogData container equals
    that of the in-memory one bitwise (one chunk, the same kernel)."""
    pytest.importorskip("h5py", reason="the .spy container is HDF5")
    adata = _ragged_analog(31)
    previous = spt.set_device(cuda_device)
    try:
        ck.csd_accumulate_tiled.launches = 0
        coh = spt.connectivityanalysis(adata, method="coh", tapsmofrq=4)
        assert ck.csd_accumulate_tiled.launches >= 1
        spt.save(adata, filename=str(tmp_path / "raw"))
        loaded = spt.load(str(tmp_path / "raw.analog"), checksum=True)
        again = spt.connectivityanalysis(loaded, method="coh", tapsmofrq=4)
    finally:
        spt.set_device(previous)
    want = np.asarray(coh.data)
    np.testing.assert_array_equal(np.asarray(again.data), want)
    spt.save(coh, filename=str(tmp_path / "coh"))
    back = spt.load(str(tmp_path / "coh.crossspectral"), checksum=True)
    got = np.asarray(back.data)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert np.array_equal(back.freq, coh.freq)


@pytest.mark.cuda
def test_resident_chain_launches_each_kernel_once_a_chunk(cuda_device):
    """Band-pass, resample to 250 Hz and coherence on the card with the
    intermediates resident: one Butterworth launch and one CSD launch a
    chunk, the input uploaded once, only the coherence read back, and the
    coherence bitwise equal to the residency-off chain (both run the same
    chunks here)."""
    from syncopy_tpu_torch.engine import resident

    rng = np.random.default_rng(5)
    data = rng.normal(size=(24 * 1000, 6)).astype(np.float32)
    trl = np.zeros((24, 3))
    trl[:, 0] = np.arange(24) * 1000
    trl[:, 1] = trl[:, 0] + 1000
    adata = spt.from_arrays(data, trl, 1000.0)

    def chain():
        bp = spt.preprocessing(adata, filter_class="but", filter_type="bp", freq=[30, 100],
                               order=4)
        rs = spt.resampledata(bp, resamplefs=250)
        return bp, rs, spt.connectivityanalysis(rs, method="coh", tapsmofrq=2)

    previous = spt.set_device(cuda_device)
    saved = resident.RESIDENT_BUDGET
    try:
        routine.clear_device_cache()
        routine.reset_transfer_counts()
        ik.sosfilt_batch.launches = 0
        ck.csd_accumulate_tiled.launches = 0
        bp, rs, coh = chain()
        counts = routine.transfer_counts()
        assert ik.sosfilt_batch.launches == 1 and ck.csd_accumulate_tiled.launches == 1
        assert isinstance(bp._data, resident.DeferredArray)
        assert isinstance(rs._data, resident.DeferredArray)
        assert counts["h2d"] == 32 * 1000 * 6 * 4 and counts["d2h"] == coh.data.nbytes
        routine.clear_device_cache()
        resident.RESIDENT_BUDGET = 0
        off = chain()
    finally:
        resident.RESIDENT_BUDGET = saved
        routine.clear_device_cache()
        spt.set_device(previous)
    assert np.array_equal(np.asarray(coh.data), np.asarray(off[2].data))


@pytest.mark.cuda
def test_cached_timelock_uploads_nothing(cuda_device):
    """timelockanalysis with covariance on the card: the first call
    uploads the payload once for its three engine passes, a second call
    takes every chunk from the trial store."""
    rng = np.random.default_rng(17)
    trl = np.array([[k * 300, k * 300 + 300, 0] for k in range(12)], dtype=float)
    adata = spt.from_arrays(rng.normal(size=(12 * 300, 6)).astype(np.float32), trl, 1000.0)
    previous = spt.set_device(cuda_device)
    try:
        routine.clear_device_cache()
        routine.reset_transfer_counts()
        first = spt.timelockanalysis(adata, covariance=True)
        assert routine.transfer_counts()["h2d"] == 16 * 300 * 6 * 4
        routine.reset_transfer_counts()
        second = spt.timelockanalysis(adata, covariance=True)
        assert routine.transfer_counts()["h2d"] == 0
    finally:
        routine.clear_device_cache()
        spt.set_device(previous)
    for name in ("avg", "var", "cov"):
        assert np.array_equal(np.asarray(getattr(first, name)), np.asarray(getattr(second, name)))


@pytest.mark.cuda
def test_kernels_launch_on_the_second_card():
    """Each hand-written kernel launches on cuda:1 (its library loaded once
    per process, its launch on that device's current stream) and agrees
    with its plain version there."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    from syncopy_tpu_torch.ops import filtering as pfilt

    dev = torch.device("cuda", 1)
    g = torch.Generator().manual_seed(0)
    spec = torch.randn(40, 33, 8, dtype=torch.complex64, generator=g)
    spec4 = torch.randn(20, 3, 33, 8, dtype=torch.complex64, generator=g)
    x = torch.randn(6, 300, 5, generator=g)
    sos = pfilt.butter_sos(4, [10, 80], "bp", 1000.0)
    with torch.cuda.device(0):  # the launches follow their tensors' device
        got = ck.csd_accumulate_tiled(spec.to(dev), 37)
        ppc = pk.ppc_accumulate_tiled(spec4.to(dev), 17)
        y = ik.sosfilt_batch(x.to(dev), sos)
    assert got.device == dev and ppc.device == dev and y.device == dev
    want = ck.csd_accumulate_tiled_plain(spec.to(dev), 37)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    pwant = pk.ppc_accumulate_tiled_plain(spec4.to(dev), 17)
    assert (ppc - pwant).abs().max() <= 1e-4 * pwant.abs().max()
    ywant = ik.sosfilt_batch_plain(x.to(dev), sos, True)
    assert (y - ywant).abs().max() <= 1e-6 * ywant.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_coherence_on_a_mesh_of_four_positions_on_the_card(cuda_device, shape):
    """Four mesh positions on one card: one CSD kernel launch per trial
    shard, within 1e-6 of the unsharded coherence."""
    rng = np.random.default_rng(5)
    data = rng.normal(size=(22 * 300, 8)).astype("f4")
    trl = np.column_stack([np.arange(22) * 300, np.arange(1, 23) * 300, np.zeros(22)])
    previous = spt.set_device(cuda_device)
    try:
        adata = spt.from_arrays(data, trl, 1000.0)
        want = np.asarray(spt.connectivityanalysis(adata, method="coh", tapsmofrq=4).data)
        mesh = spt.make_mesh(n_trial=shape[0], n_channel=shape[1], devices=[cuda_device] * 4)
        ck.csd_accumulate_tiled.launches = 0
        with spt.use_mesh(mesh):
            got = np.asarray(spt.connectivityanalysis(adata, method="coh", tapsmofrq=4).data)
        assert ck.csd_accumulate_tiled.launches == shape[0]  # one 32-trial chunk
    finally:
        routine.clear_device_cache()
        spt.set_device(previous)
    assert np.abs(got - want).max() <= 1e-6
