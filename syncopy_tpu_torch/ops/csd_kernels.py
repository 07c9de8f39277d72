# -*- coding: utf-8 -*-
#
# Tiled cross-spectral density accumulation: the hand-written CUDA kernel
# (csrc/csd_accumulate.cu), its loader, its plain PyTorch version and the
# wrapper that picks between them by the tensor's device.
#
# Replaces the TPU kernel syncopy_tpu/ops/pallas_kernels.py::
# csd_accumulate_tiled (body _csd_tiled_kernel). Bounded on the H100 by the
# FP32 FMA pipes: 8*F*N*C^2 ~ 49 GFLOP at the bench shape (N=3000 rows,
# F=501, C=64), about half that with Hermitian symmetry, over a 0.77 GB
# spectrum (an estimate from shapes, not a measurement). Tensor cores stay
# unused because TF32 would break the 1e-5 relative bar. The kernel reads
# the complex64 spectrum in place, computes only the i <= j channel tiles
# and mirrors them, and keeps the TPU kernel's numerics (256-row float32
# groups, TwoSum across groups, rows past n_valid never read).

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from .connectivity import gram_sum_twosum

__all__ = ["csd_accumulate_tiled", "csd_accumulate_tiled_plain", "load_csd_kernel"]

#: rows per float32 group before the TwoSum (the TPU kernel's row_block)
ROW_BLOCK = 256

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "csd_accumulate.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
#: CUDA toolkit roots searched for nvcc after $CUDA_HOME and $PATH
_CUDA_HOMES = ("/usr/local/cuda",)

_lib = None


def _find_nvcc():
    homes = [os.environ.get("CUDA_HOME")] + list(_CUDA_HOMES)
    for home in homes:
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc")


def load_csd_kernel():
    """
    Build (once per source hash) and load the CUDA kernel's shared library.

    The library goes to ``build/csd_accumulate-<hash>.so`` at the checkout
    root, named by a hash of the source and the nvcc flags, so a changed
    source never loads a stale build. Raises RuntimeError when nvcc is
    missing or the compile fails.
    """
    global _lib
    if _lib is not None:
        return _lib
    src = _SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    so_path = _BUILD_DIR / "csd_accumulate-{}.so".format(digest)
    if not so_path.exists():
        nvcc = _find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                "cannot build {}: nvcc not found (set CUDA_HOME or put nvcc on PATH)".format(_SOURCE)
            )
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # compile to a private name, then rename: concurrent builders never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [nvcc, *_NVCC_FLAGS, "-o", tmp, str(_SOURCE)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    "nvcc failed on {} (exit {}):\n{}".format(_SOURCE, proc.returncode, proc.stderr)
                )
            os.replace(tmp, so_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(so_path))
    fn = lib.csd_accumulate_tiled_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def csd_accumulate_tiled_plain(spec, n_valid):
    """
    Plain PyTorch version of :func:`csd_accumulate_tiled`: a where-mask
    (NaN-safe, unlike a multiply) on the rows at or past `n_valid`, then
    256-row complex64 matmul partials combined by TwoSum.
    """
    N = spec.shape[0]
    valid = torch.arange(N, device=spec.device) < n_valid
    masked = torch.where(valid[:, None, None], spec, torch.zeros((), dtype=spec.dtype, device=spec.device))
    return gram_sum_twosum(masked, ROW_BLOCK)


def csd_accumulate_tiled(spec, n_valid):
    """
    Accumulated cross-spectra from an (N, F, C) complex64 spectrum:
    ``cs[f, i, j] = sum_{n < n_valid} spec[n, f, i] * conj(spec[n, f, j])``.

    A CPU tensor takes the plain version. A CUDA tensor launches the
    hand-written kernel on the current stream, or raises: it never falls
    back. `n_valid` is a host int with ``0 <= n_valid <= N``.

    Returns (F, C, C) complex64 on the input's device.
    """
    if spec.ndim != 3:
        raise ValueError("spec must be (N, F, C), got shape {}".format(tuple(spec.shape)))
    N, F, C = spec.shape
    n_valid = int(n_valid)
    if not 0 <= n_valid <= N:
        raise ValueError("n_valid must lie in [0, {}], got {}".format(N, n_valid))
    if spec.device.type == "cpu":
        return csd_accumulate_tiled_plain(spec, n_valid)
    if spec.device.type != "cuda":
        raise ValueError("csd_accumulate_tiled runs on cpu or cuda, not {}".format(spec.device))
    if spec.dtype != torch.complex64:
        raise TypeError("spec must be complex64, got {}".format(spec.dtype))
    if not spec.is_contiguous():
        raise ValueError("spec must be contiguous")
    lib = load_csd_kernel()
    out = torch.empty((F, C, C), dtype=torch.complex64, device=spec.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(spec.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.csd_accumulate_tiled_launch(
            spec.data_ptr(), out.data_ptr(), N, F, C, n_valid, stream
        )
    if rc != 0:
        raise RuntimeError("csd_accumulate_tiled kernel launch failed: cudaError {}".format(rc))
    csd_accumulate_tiled.launches += 1
    return out


#: kernel launches since the last reset (set to 0 to start a count)
csd_accumulate_tiled.launches = 0
