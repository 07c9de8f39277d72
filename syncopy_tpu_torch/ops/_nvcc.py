# -*- coding: utf-8 -*-
#
# Build and load the port's CUDA sources (csrc/<name>.cu) with nvcc, into
# shared libraries with a plain C interface bound through ctypes. A source
# builds at first use into build/<name>-<hash>.so at the checkout root,
# named by a hash of the source and the flags, so a changed source never
# loads a stale build.

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["load_library"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
#: sm_90a keeps Hopper's wgmma/setmaxnreg available; never --use_fast_math
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
#: CUDA toolkit roots searched for nvcc after $CUDA_HOME and before $PATH
CUDA_HOMES = ("/usr/local/cuda",)

_libs = {}


def _find_nvcc():
    for home in [os.environ.get("CUDA_HOME"), *CUDA_HOMES]:
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc")


def load_library(name):
    """
    Build (once per source hash) and load ``csrc/<name>.cu``; returns the
    ``ctypes.CDLL``, whose symbols the caller types. Raises RuntimeError
    when nvcc is missing or the compile fails.
    """
    if name in _libs:
        return _libs[name]
    source = CSRC_DIR / "{}.cu".format(name)
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so_path = BUILD_DIR / "{}-{}.so".format(name, digest)
    if not so_path.exists():
        nvcc = _find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                "cannot build {}: nvcc not found (set CUDA_HOME or put nvcc on PATH)".format(source)
            )
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # compile to a private name, then rename: concurrent builders never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(source)], capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    "nvcc failed on {} (exit {}):\n{}".format(source, proc.returncode, proc.stderr)
                )
            os.replace(tmp, so_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(so_path))
    _libs[name] = lib
    return lib
