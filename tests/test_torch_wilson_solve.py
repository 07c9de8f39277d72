# -*- coding: utf-8 -*-
# The solve in Wilson's step, psi^-1 U (ops/connectivity.py::_solve_nan), on
# the CPU: the route it takes (ops/wilson_kernels.py::solve_route; the
# hand-written kernel of csrc/wilson_solve.cu runs only on a card, and its
# tests are in test_torch_cuda.py), the plain version's bits against the
# port's earlier inv_ex step, NaN in a singular bin only, and the counters
# wilson_counts() keeps of the steps' solves by route.

import numpy as np
import pytest
import torch

from syncopy_tpu_torch.ops import connectivity as pops
from syncopy_tpu_torch.ops import wilson_kernels as wk

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_counts():
    pops.reset_wilson_counts()
    yield
    pops.reset_wilson_counts()


def _batch(shape, n, seed):
    """(*shape, n, n) complex128 psi (diagonally loaded) and U."""
    rng = np.random.default_rng(seed)
    draw = lambda: rng.normal(size=shape + (n, n)) + 1j * rng.normal(size=shape + (n, n))  # noqa: E731
    psi = draw() + 2 * np.sqrt(n) * np.eye(n)
    return torch.from_numpy(psi), torch.from_numpy(draw())


@pytest.mark.parametrize("lead", [(7,), (2, 5)], ids=["F", "BF"])
@pytest.mark.parametrize("n", [1, 2, 3, 8, 33, 128])
def test_cpu_solve_is_inv_times_u_bitwise(n, lead):
    psi, U = _batch(lead if n < 128 else lead[:-1] + (2,), n, seed=n)
    got = pops._solve_nan(psi, U)
    want = pops._inv_nan(psi) @ U
    assert got.dtype == torch.complex128 and got.shape == U.shape
    assert torch.equal(got, want)
    assert torch.equal(wk.wilson_solve_plain(psi, U), want)
    assert pops.wilson_counts()["solve_library"] == 1
    assert pops.wilson_counts()["solve_kernel"] == 0


def test_singular_bin_is_nan_alone():
    psi, U = _batch((4,), 6, seed=1)
    psi[2, :, 3] = 0  # a zero column: the pivot of column 3 is exactly zero
    got = pops._solve_nan(psi, U)
    assert torch.isnan(got[2]).all()
    keep = [0, 1, 3]
    assert not torch.isnan(got[keep]).any()
    assert torch.equal(got[keep], (torch.linalg.inv(psi[keep]) @ U[keep]))


@pytest.mark.parametrize("device, dtype, n, route", [
    ("cuda", torch.complex128, 1, "kernel"),
    ("cuda", torch.complex128, 128, "kernel"),
    ("cuda:1", torch.complex128, 256, "kernel"),
    ("cuda", torch.complex128, 257, "library"),
    ("cuda", torch.complex64, 128, "library"),
    ("cuda", torch.float64, 128, "library"),
    ("cpu", torch.complex128, 128, "library"),
    ("cpu", torch.complex64, 2, "library"),
])
def test_route_by_device_dtype_and_channels(device, dtype, n, route):
    assert wk.solve_route(torch.device(device), dtype, n) == route
    assert wk.solve_route(device, dtype, n) == route


def test_kernel_refuses_cpu_tensors():
    psi, U = _batch((3,), 4, seed=2)
    with pytest.raises(ValueError, match="CUDA"):
        wk.wilson_solve(psi, U)
    with pytest.raises(ValueError, match="one shape"):
        wk.wilson_solve(psi, U[..., :3])


def _csd(F, n, seed):
    """A one-sided (F, n, n) complex128 CSD of a random white process,
    Hermitian positive definite at every bin."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(F, 4 * n, n)) + 1j * rng.normal(size=(F, 4 * n, n))
    csd = np.einsum("fti,ftj->fij", x, x.conj()) / (4 * n)
    return torch.from_numpy(csd)


@pytest.mark.parametrize("form", ["one_sided", "two_sided"])
def test_counts_one_library_solve_a_step(form):
    wilson = pops.wilson_sf if form == "one_sided" else pops.wilson_sf_twosided
    H, Sigma, conv, err, it = wilson(_csd(17, 4, seed=3), nIter=40, rtol=1e-9)
    counts = pops.wilson_counts()
    assert counts[form + "_steps"] > 1
    assert counts["solve_library"] == counts[form + "_steps"]
    assert counts["solve_kernel"] == 0
    assert bool(torch.isfinite(H).all())


def test_reset_clears_solve_counts():
    pops._solve_nan(*_batch((2,), 3, seed=4))
    assert pops.wilson_counts()["solve_library"] == 1
    pops.reset_wilson_counts()
    assert pops.wilson_counts()["solve_library"] == 0
