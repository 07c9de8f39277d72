# -*- coding: utf-8 -*-
#
# Profiling / tracing facilities: the JAX package's profile() on
# torch.profiler, and its wall-clock Timer.

import contextlib
import os
import time

__all__ = ["profile", "Timer"]


@contextlib.contextmanager
def profile(logdir=None):
    """
    Trace the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write a Chrome trace,
    ``trace_<pid>_<time ns>.json``, into `logdir`::

        with spt.profile("traces"):
            spt.freqanalysis(data, ...)

    View it in ui.perfetto.dev or chrome://tracing. Defaults to
    ``$SPYDIR/traces``. Yields `logdir`.
    """
    import torch

    if logdir is None:
        spydir = os.environ.get("SPYDIR", os.path.join(os.path.expanduser("~"), ".spy"))
        logdir = os.path.join(spydir, "traces")
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, "trace_{}_{}.json".format(os.getpid(), time.time_ns())))


class Timer:
    """Wall-clock context timer: ``with Timer() as t: ...; t.seconds``."""

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return False
