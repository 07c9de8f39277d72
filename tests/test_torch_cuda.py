# -*- coding: utf-8 -*-
# Card-only tests of the port: the CUDA CSD kernel against a complex128
# oracle and its plain version, and the coherence main path on the card
# against the same path on the CPU. They skip where no CUDA device is
# present (the kernel has no CPU mode). This file imports no jax, so on a
# machine without it run: python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

import numpy as np
import pytest
import torch

import syncopy_tpu_torch as spt
from syncopy_tpu_torch.engine import routine
from syncopy_tpu_torch.ops import csd_kernels as ck

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


def _spec(N, F, C, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, F, C)) + 1j * rng.normal(size=(N, F, C))).astype(np.complex64)


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
    lens = [400] * 9 + [300] * 4
    rng = np.random.default_rng(3)
    data = rng.normal(size=(sum(lens), 6)).astype(np.float32)
    trl = np.zeros((len(lens), 3))
    trl[:, 1] = np.cumsum(lens)
    trl[1:, 0] = trl[:-1, 1]
    adata = spt.from_arrays(data, trl, 1000.0)
    monkeypatch.setattr(routine, "DEFAULT_CHUNK_BUDGET", 4 * 400 * 6 * 4 * 2)
    ck.csd_accumulate_tiled.launches = 0
    got = np.asarray(spt.connectivityanalysis(adata, method="coh", tapsmofrq=4).data)
    assert ck.csd_accumulate_tiled.launches == 3 + 1  # 9 trials in chunks of 4, 4 in one
    monkeypatch.setattr(routine, "default_device", lambda: torch.device("cpu"))
    want = np.asarray(spt.connectivityanalysis(adata, method="coh", tapsmofrq=4).data)
    assert np.abs(got - want).max() < 1e-5
