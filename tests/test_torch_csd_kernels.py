# -*- coding: utf-8 -*-
# Parity tests for syncopy_tpu_torch/ops/csd_kernels.py: the plain PyTorch
# version of the tiled CSD accumulation against the JAX package's Pallas
# kernel (interpret mode) and a float64 oracle, the CPU dispatch of the
# wrapper and the CUDA build entry point. The CUDA kernel itself is tested
# in test_torch_cuda.py.

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from syncopy_tpu.ops.pallas_kernels import csd_accumulate, csd_accumulate_tiled as jax_tiled
from syncopy_tpu_torch.ops import csd_kernels as ck

torch.set_num_threads(1)

#: max|got - oracle| / max|oracle| (the bar of test_connectivity.py:1279-1352)
REL_TOL = 1e-5

#: (N, F, C, n_valid, NaN rows past n_valid): block-unaligned shapes
CASES = [(111, 101, 24, 87, False), (40, 17, 8, 25, True), (3, 2, 4, 3, False)]


def _spec(N, F, C, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, F, C)) + 1j * rng.normal(size=(N, F, C))).astype(np.complex64)


def _oracle(spec, n_valid):
    rows = spec[:n_valid].astype(np.complex128)
    return np.einsum("nfi,nfj->fij", rows, np.conj(rows))


@pytest.mark.parametrize("N, F, C, nv, nan_rows", CASES)
def test_plain_matches_pallas_and_oracle(N, F, C, nv, nan_rows):
    spec = _spec(N, F, C, seed=N)
    want = _oracle(spec, nv)
    if nan_rows:
        spec[nv:] = np.nan
    got = ck.csd_accumulate_tiled_plain(torch.from_numpy(spec), nv).numpy()
    ref = np.asarray(jax_tiled(jnp.asarray(spec.real), jnp.asarray(spec.imag), nv,
                               interpret=True))
    scale = np.abs(want).max()
    assert got.shape == (F, C, C) and got.dtype == np.complex64
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() / scale < REL_TOL
    assert np.abs(got - ref).max() / scale < REL_TOL
    assert np.abs(got - np.conj(np.swapaxes(got, 1, 2))).max() < 1e-4 * scale


def test_plain_zero_valid_rows_exact_zeros():
    spec = _spec(3, 2, 4, seed=5)
    spec[0, 0, 0] = np.nan
    got = ck.csd_accumulate_tiled_plain(torch.from_numpy(spec), 0).numpy()
    ref = np.asarray(jax_tiled(jnp.asarray(spec.real), jnp.asarray(spec.imag), 0,
                               interpret=True))
    assert np.all(got == 0) and np.all(ref == 0)


def test_plain_groups_combine_across_row_blocks():
    """More rows than one 256-row group: the TwoSum path across groups."""
    spec = _spec(600, 3, 5, seed=9)
    got = ck.csd_accumulate_tiled_plain(torch.from_numpy(spec), 555).numpy()
    want = _oracle(spec, 555)
    assert np.abs(got - want).max() / np.abs(want).max() < REL_TOL


def test_untiled_pallas_kernel_through_transposed_view():
    """The untiled Pallas kernel csd_accumulate maps (F, N, C) to the same
    Gram: the tiled port with n_valid = N on the transposed view covers it
    (the cases of test_connectivity.py:1156-1191)."""
    spec = _spec(12, 5, 8, seed=7).transpose(1, 0, 2).copy()  # (F, N, C)
    cs_re, cs_im = csd_accumulate(jnp.asarray(spec.real), jnp.asarray(spec.imag),
                                  interpret=True)
    ref = np.asarray(cs_re) + 1j * np.asarray(cs_im)
    rows = torch.from_numpy(spec).permute(1, 0, 2).contiguous()
    got = ck.csd_accumulate_tiled(rows, rows.shape[0]).numpy()
    want = np.einsum("fni,fnj->fij", spec, np.conj(spec))
    assert np.allclose(got, want, atol=1e-4)
    assert np.allclose(got, ref, atol=1e-4)
    assert np.allclose(got, np.conj(np.swapaxes(got, 1, 2)), atol=1e-5)


def test_untiled_zero_and_single_row():
    one = np.zeros((2, 1, 4), dtype=np.complex64)  # (F, N, C)
    one[0, 0, 1] = 2.0
    got = ck.csd_accumulate_tiled(torch.from_numpy(one).permute(1, 0, 2).contiguous(), 1)
    want = np.einsum("fni,fnj->fij", one.real, one.real)
    assert np.allclose(got.real.numpy(), want)
    assert np.allclose(got.imag.numpy(), 0.0)


def test_wrapper_on_cpu_takes_plain_version_and_counts_nothing():
    spec = torch.from_numpy(_spec(40, 17, 8, seed=4))
    before = ck.csd_accumulate_tiled.launches
    got = ck.csd_accumulate_tiled(spec, 25)
    assert ck.csd_accumulate_tiled.launches == before
    assert torch.equal(got, ck.csd_accumulate_tiled_plain(spec, 25))


@pytest.mark.parametrize("shape, nv", [((4, 3), 2), ((4, 3, 2), 5), ((4, 3, 2), -1)])
def test_wrapper_rejects_bad_arguments(shape, nv):
    with pytest.raises(ValueError):
        ck.csd_accumulate_tiled(torch.zeros(shape, dtype=torch.complex64), nv)


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(ck, "_lib", None)
    monkeypatch.setattr(ck, "_BUILD_DIR", ck._BUILD_DIR / "absent-for-test")
    monkeypatch.setattr(ck, "_CUDA_HOMES", ())
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ck.load_csd_kernel()
