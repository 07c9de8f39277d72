# -*- coding: utf-8 -*-
# Parity tests for syncopy_tpu_torch/ops/csd_kernels.py: the plain PyTorch
# versions of the tiled and the untiled CSD accumulation against the JAX
# package's Pallas kernels (interpret mode) and a float64 oracle, the CPU
# dispatch of the wrappers and the CUDA build entry point. The CUDA kernels
# themselves are tested in test_torch_cuda.py.

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from syncopy_tpu.ops.pallas_kernels import csd_accumulate, csd_accumulate_tiled as jax_tiled
from syncopy_tpu_torch.ops import _nvcc
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
    """The untiled Pallas kernel csd_accumulate (the case of
    test_connectivity.py:1161-1178): its port on the (F, N, C) planes and
    the tiled port with n_valid = N on the transposed view give the same
    Gram."""
    spec = _spec(12, 5, 8, seed=7).transpose(1, 0, 2).copy()  # (F, N, C)
    cs_re, cs_im = csd_accumulate(jnp.asarray(spec.real), jnp.asarray(spec.imag),
                                  interpret=True)
    ref = np.asarray(cs_re) + 1j * np.asarray(cs_im)
    want = np.einsum("fni,fnj->fij", spec, np.conj(spec))
    got_re, got_im = ck.csd_accumulate_plain(torch.from_numpy(spec.real.copy()),
                                             torch.from_numpy(spec.imag.copy()))
    assert got_re.shape == got_im.shape == (5, 8, 8)
    assert got_re.dtype == got_im.dtype == torch.float32
    rows = torch.from_numpy(spec).permute(1, 0, 2).contiguous()
    for got in (got_re.numpy() + 1j * got_im.numpy(),
                ck.csd_accumulate_tiled(rows, rows.shape[0]).numpy()):
        assert np.allclose(got, want, atol=1e-4)
        assert np.allclose(got, ref, atol=1e-4)
        assert np.allclose(got, np.conj(np.swapaxes(got, 1, 2)), atol=1e-5)


def test_untiled_zero_and_single_row():
    """One row of real input (test_connectivity.py:1180-1191), through the
    untiled port, the JAX kernel and the tiled port."""
    one = np.zeros((2, 1, 4), dtype=np.float32)  # (F, N, C)
    one[0, 0, 1] = 2.0
    want = np.einsum("fni,fnj->fij", one, one)
    cs_re, cs_im = ck.csd_accumulate_plain(torch.from_numpy(one), torch.zeros(2, 1, 4))
    jre, jim = csd_accumulate(jnp.asarray(one), jnp.asarray(np.zeros_like(one)), interpret=True)
    tiled = ck.csd_accumulate_tiled(
        torch.from_numpy(one.astype(np.complex64)).permute(1, 0, 2).contiguous(), 1)
    for re, im in ((cs_re.numpy(), cs_im.numpy()), (np.asarray(jre), np.asarray(jim)),
                   (tiled.real.numpy(), tiled.imag.numpy())):
        assert np.allclose(re, want)
        assert np.allclose(im, 0.0)


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
    monkeypatch.setattr(_nvcc, "_libs", {})
    monkeypatch.setattr(_nvcc, "BUILD_DIR", _nvcc.BUILD_DIR / "absent-for-test")
    monkeypatch.setattr(_nvcc, "CUDA_HOMES", ())
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ck.load_csd_kernel()


# -- the untiled csd_accumulate: (F, N, C) float32 planes ------------------ #


def _planes(F, N, C, seed):
    spec = _spec(F, N, C, seed)  # (F, N, C)
    return spec, torch.from_numpy(spec.real.copy()), torch.from_numpy(spec.imag.copy())


def test_untiled_plain_probe_shape():
    """The pallas_supported() probe's (1, 8, 128) zeros give zeros."""
    zeros = torch.zeros(1, 8, 128)
    cs_re, cs_im = ck.csd_accumulate_plain(zeros, zeros)
    assert cs_re.shape == (1, 128, 128)
    assert not cs_re.any() and not cs_im.any()


def test_untiled_wrapper_on_cpu_takes_plain_version_and_counts_nothing():
    _, re, im = _planes(3, 20, 6, seed=2)
    ck.csd_accumulate.launches = 0
    got = ck.csd_accumulate(re, im)
    want = ck.csd_accumulate_plain(re, im)
    assert ck.csd_accumulate.launches == 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("re_shape, im_shape", [((4, 3), (4, 3)), ((2, 4, 3), (2, 4, 4))])
def test_untiled_wrapper_rejects_bad_shapes(re_shape, im_shape):
    with pytest.raises(ValueError):
        ck.csd_accumulate(torch.zeros(re_shape), torch.zeros(im_shape))
