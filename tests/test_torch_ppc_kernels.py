# -*- coding: utf-8 -*-
# Parity tests for syncopy_tpu_torch/ops/ppc_kernels.py: the plain PyTorch
# version of the PPC resultant accumulation against the JAX package's
# Pallas kernel (interpret mode) and a complex128 oracle, on the cases of
# test_connectivity.py::TestPallasPPCKernel; the CPU dispatch of the
# wrapper, its argument checks and the CUDA build entry point. The CUDA
# kernel itself is tested in test_torch_cuda.py.

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from syncopy_tpu.ops.pallas_kernels import ppc_accumulate_tiled as jax_ppc
from syncopy_tpu_torch.ops import _nvcc
from syncopy_tpu_torch.ops import ppc_kernels as pk

torch.set_num_threads(1)

#: max|got - want| (the bar of test_connectivity.py:1194-1276): U sums
#: unit phasors, so the error is absolute, relative to n_valid
ABS_TOL = 1e-4


def _spec(N, K, F, C, seed):
    rng = np.random.default_rng(seed)
    shape = (N, K, F, C)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def _oracle(spec, n_valid):
    spec = spec[:n_valid].astype(np.complex128)
    csd = np.einsum("nkfi,nkfj->nfij", spec, np.conj(spec))
    mag = np.abs(csd)
    unit = np.where(mag > 0, csd / np.where(mag > 0, mag, 1.0), 0.0)
    return unit.sum(axis=0)


def _jax(spec, n_valid):
    return np.asarray(jax_ppc(jnp.asarray(spec.real), jnp.asarray(spec.imag), n_valid,
                              interpret=True))


#: (N, K, F, C, n_valid, NaN trials past n_valid, seed): block-unaligned,
#: full count, NaN padding (test_connectivity.py:1206-1276)
CASES = [(21, 3, 11, 8, 17, False, 5), (16, 2, 8, 4, 16, False, 8),
         (13, 2, 9, 6, 9, True, 11)]


@pytest.mark.parametrize("N, K, F, C, nv, nan_trials, seed", CASES)
def test_plain_matches_pallas_and_oracle(N, K, F, C, nv, nan_trials, seed):
    spec = _spec(N, K, F, C, seed)
    want = _oracle(spec, nv)
    if nan_trials:
        spec[nv:] = np.nan
    got = pk.ppc_accumulate_tiled_plain(torch.from_numpy(spec), nv).numpy()
    ref = _jax(spec, nv)
    assert got.shape == (F, C, C) and got.dtype == np.complex64
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < ABS_TOL
    assert np.abs(got - ref).max() < ABS_TOL
    # resultant terms are unit phasors: the diagonal equals n_valid
    assert np.allclose(got[:, np.arange(C), np.arange(C)].real, nv, atol=1e-3)


#: data scales: 1e-13 is MEG in tesla (|csd| ~ 1e-26, whose square
#: underflows float32), 1e-18 puts |csd|^2 far below the denormals, 1e10
#: overflows it
SCALES = [1.0, 1e-13, 1e-18, 1e10]


@pytest.mark.parametrize("scale", SCALES)
def test_plain_matches_oracle_at_every_scale(scale):
    """The unit phasor does not depend on the spectrum's scale."""
    N, K, F, C, nv = 21, 3, 11, 8, 17
    spec = (_spec(N, K, F, C, seed=5) * np.float32(scale)).astype(np.complex64)
    want = _oracle(spec, nv)
    spec[nv:] = np.nan
    got = pk.ppc_accumulate_tiled_plain(torch.from_numpy(spec), nv).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() / nv < 1e-5
    assert np.allclose(got[:, np.arange(C), np.arange(C)], nv, atol=1e-3)


def test_plain_finite_on_denormal_cross_spectra():
    """At spectrum scale 1e-20 the per-trial CSD is denormal: its phasor
    is coarse but finite (a float32 magnitude and division gave NaN)."""
    spec = (_spec(21, 3, 11, 8, seed=5) * np.float32(1e-20)).astype(np.complex64)
    got = pk.ppc_accumulate_tiled_plain(torch.from_numpy(spec), 17).numpy()
    assert np.isfinite(got).all()
    assert np.allclose(got[:, np.arange(8), np.arange(8)], 17, atol=1e-3)


def test_pallas_kernel_drops_terms_out_of_float32_square_range():
    """A recorded fault of the JAX package (its kernel stays as it is): the
    Pallas body squares the unscaled CSD, so at spectrum scale 1e-13 every
    term underflows to 0 and is dropped, where the port's plain version
    keeps it."""
    spec = (_spec(21, 3, 11, 8, seed=5) * np.float32(1e-13)).astype(np.complex64)
    want = _oracle(spec, 17)
    assert np.abs(_jax(spec, 17)).max() == 0
    got = pk.ppc_accumulate_tiled_plain(torch.from_numpy(spec), 17).numpy()
    assert np.abs(got - want).max() / 17 < 1e-5


def test_plain_ppc_value_on_full_count():
    N, K, F, C = 16, 2, 8, 4
    spec = _spec(N, K, F, C, seed=8)
    U = pk.ppc_accumulate_tiled_plain(torch.from_numpy(spec), N).numpy()
    want = _oracle(spec, N)
    ppc_got = ((U * np.conj(U)).real - N) / (N * (N - 1))
    ppc_want = ((want * np.conj(want)).real - N) / (N * (N - 1))
    assert np.abs(ppc_got - ppc_want).max() < ABS_TOL
    assert np.allclose(ppc_got[:, np.arange(C), np.arange(C)], 1.0, atol=1e-4)


def test_plain_zero_trials_exact_zeros():
    spec = np.zeros((4, 1, 3, 4), dtype=np.complex64)
    spec[0, 0, 0, 0] = np.nan
    got = pk.ppc_accumulate_tiled_plain(torch.from_numpy(spec), 0).numpy()
    assert np.all(got == 0)
    assert np.allclose(_jax(np.zeros_like(spec), 0), 0.0)


def test_plain_zero_bins_add_nothing():
    """Bins of zero magnitude add 0, not 0/0 = NaN."""
    spec = _spec(6, 2, 5, 3, seed=2)
    spec[:, :, 1] = 0
    got = pk.ppc_accumulate_tiled_plain(torch.from_numpy(spec), 6).numpy()
    assert np.isfinite(got).all() and np.all(got[1] == 0)
    assert np.abs(got - _jax(spec, 6)).max() < ABS_TOL


def test_plain_trial_groups(monkeypatch):
    """A stack budget of two trials splits the sum into groups; the
    result does not depend on the grouping."""
    spec = torch.from_numpy(_spec(9, 3, 4, 5, seed=3))
    whole = pk.ppc_accumulate_tiled_plain(spec, 7)
    monkeypatch.setattr(pk, "PLAIN_STACK_BYTES", 2 * 4 * 5 * 5 * 16)
    grouped = pk.ppc_accumulate_tiled_plain(spec, 7)
    assert torch.allclose(whole, grouped, atol=1e-5)
    assert np.abs(grouped.numpy() - _oracle(spec.numpy(), 7)).max() < ABS_TOL


def test_wrapper_on_cpu_takes_plain_version_and_counts_nothing():
    spec = torch.from_numpy(_spec(13, 2, 9, 6, seed=11))
    pk.ppc_accumulate_tiled.launches = 0
    got = pk.ppc_accumulate_tiled(spec, 9)
    assert pk.ppc_accumulate_tiled.launches == 0
    assert torch.equal(got, pk.ppc_accumulate_tiled_plain(spec, 9))


@pytest.mark.parametrize("shape, nv", [((4, 3, 2), 2), ((4, 1, 3, 2), 5), ((4, 1, 3, 2), -1)])
def test_wrapper_rejects_bad_arguments(shape, nv):
    with pytest.raises(ValueError):
        pk.ppc_accumulate_tiled(torch.zeros(shape, dtype=torch.complex64), nv)


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_nvcc, "_libs", {})
    monkeypatch.setattr(_nvcc, "BUILD_DIR", _nvcc.BUILD_DIR / "absent-for-test")
    monkeypatch.setattr(_nvcc, "CUDA_HOMES", ())
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        pk.load_ppc_kernel()
