# -*- coding: utf-8 -*-
#
# syncopy_tpu_torch: the PyTorch/CUDA port of syncopy_tpu for one NVIDIA
# H100. It keeps the JAX package's module layout and names; hand-written
# CUDA kernels live in csrc/. Imports torch, never jax.

import numpy as np
import torch

__version__ = "0.1.0"

# Float32 contractions on the card stay full float32: TF32 keeps ~10
# mantissa bits and would break the 1e-5 coherence bar. cuBLAS already
# defaults to this; cuDNN does not, so both are set here, for the process.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .datatype import (  # noqa: E402
    AnalogData,
    CrossSpectralData,
    Selector,
    SpectralData,
    SpikeData,
    TimeLockData,
)
from .connectivity import connectivityanalysis  # noqa: E402
from .engine.routine import set_device  # noqa: E402
from .preproc import preprocessing, resampledata  # noqa: E402
from .specest import freqanalysis  # noqa: E402
from .statistics import itc, mean, median, spike_psth, std, timelockanalysis, var  # noqa: E402

__all__ = [
    "AnalogData",
    "CrossSpectralData",
    "SpectralData",
    "SpikeData",
    "TimeLockData",
    "Selector",
    "connectivityanalysis",
    "freqanalysis",
    "from_arrays",
    "itc",
    "mean",
    "median",
    "preprocessing",
    "resampledata",
    "set_device",
    "spike_psth",
    "std",
    "timelockanalysis",
    "var",
]


def from_arrays(data, trialdefinition, samplerate, channel=None):
    """
    The port's :class:`AnalogData` from the same numpy arrays that build a
    ``syncopy_tpu.AnalogData``: a (samples, channels) payload with trials
    stacked along time, an ``[start, stop, offset]`` trialdefinition in
    samples, the sampling rate in Hz and optional channel labels.
    """
    return AnalogData(
        data=np.asarray(data), trialdefinition=np.asarray(trialdefinition),
        samplerate=samplerate, channel=channel,
    )
