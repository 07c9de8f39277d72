# -*- coding: utf-8 -*-
#
# syncopy_tpu_torch: the PyTorch/CUDA port of syncopy_tpu for one NVIDIA
# H100. It keeps the JAX package's module layout and names, and exports
# every name of its namespace; hand-written CUDA kernels live in csrc/.
# Imports torch, never jax, and touches no device while it is imported.

import numpy as np
import torch

__version__ = "0.1.0"

# Float32 contractions on the card stay full float32: TF32 keeps ~10
# mantissa bits and would break the 1e-5 coherence bar. cuBLAS already
# defaults to this; cuDNN does not, so both are set here, for the process.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .shared.errors import (  # noqa: E402,F401
    SPYError,
    SPYTypeError,
    SPYValueError,
    SPYIOError,
    SPYParallelError,
    SPYWarning,
    SPYInfo,
    SPYLog,
    log,
)
from .shared.tools import StructDict, SerializableDict, get_defaults, best_match  # noqa: E402,F401
from .shared.log import setup_logging, get_logger, set_loglevel  # noqa: E402,F401
from .shared.profiling import profile, Timer  # noqa: E402,F401
from .datatype.util import __sessionid__, storage_dir  # noqa: E402,F401

#: the session's temp-storage directory (created when a file is first
#: written there); its files are named with ``__sessionid__``, which
#: ``clear()`` and ``cleanup()`` read too
__storage__ = storage_dir()

from .datatype import (  # noqa: E402
    AnalogData,
    CrossSpectralData,
    EventData,
    Selector,
    SpectralData,
    SpikeData,
    TimeIndexer,
    TimeLockData,
    TrialIndexer,
    concat,
    copy,
    definetrial,
    redefinetrial,
    selectdata,
    show,
)
from .engine.routine import ComputationalRoutine, clear_device_cache, set_device  # noqa: E402
from .parallel.mesh import (  # noqa: E402,F401
    make_mesh,
    use_mesh,
    active_mesh,
    cluster_cleanup,
    esi_cluster_setup,
    init_distributed,
)
from .specest import freqanalysis  # noqa: E402
from .connectivity import connectivityanalysis  # noqa: E402
from .preproc import preprocessing, resampledata  # noqa: E402
from .statistics import itc, mean, median, spike_psth, std, timelockanalysis, var  # noqa: E402
from .io import save, load, load_ft_raw, load_tdt, load_nwb, cleanup, clear  # noqa: E402
from .io import mne_conv  # noqa: E402,F401
from .io.mne_conv import (  # noqa: E402,F401
    raw_adata_to_mne_raw,
    raw_mne_to_adata,
    tldata_to_mne_epochs,
    mne_epochs_to_tldata,
)
from .plotting import singlepanelplot, multipanelplot  # noqa: E402
from . import synthdata  # noqa: E402
from .ops.wavelet import (  # noqa: E402,F401
    Morlet,
    Paul,
    DOG,
    Ricker,
    MorletSL,
    cwt,
    WaveletAnalysis,
    WaveletTransform,
)

#: aliases kept for reference-API parity
Marr = Ricker
Mexican_hat = Ricker

__all__ = [
    "AnalogData",
    "SpectralData",
    "CrossSpectralData",
    "TimeLockData",
    "SpikeData",
    "EventData",
    "Selector",
    "StructDict",
    "definetrial",
    "redefinetrial",
    "selectdata",
    "show",
    "concat",
    "freqanalysis",
    "connectivityanalysis",
    "preprocessing",
    "resampledata",
    "mean",
    "std",
    "var",
    "median",
    "itc",
    "spike_psth",
    "timelockanalysis",
    "save",
    "load",
    "load_ft_raw",
    "load_tdt",
    "load_nwb",
    "cleanup",
    "clear",
    "singlepanelplot",
    "multipanelplot",
    "synthdata",
    "make_mesh",
    "use_mesh",
    "cluster_cleanup",
    "ComputationalRoutine",
    "get_defaults",
    "best_match",
    "setup_logging",
    "set_loglevel",
    "copy",
    "TrialIndexer",
    "TimeIndexer",
    "Morlet",
    "Paul",
    "DOG",
    "Ricker",
    "MorletSL",
    "Marr",
    "Mexican_hat",
    "cwt",
    "profile",
    "Timer",
    "from_arrays",
    "set_device",
    "clear_device_cache",
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
