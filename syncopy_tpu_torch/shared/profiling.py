# -*- coding: utf-8 -*-
#
# Profiling / tracing facilities: the JAX package's profile() on
# torch.profiler, the port's spans inside it, and its wall-clock Timer.

import contextlib
import functools
import os
import time

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["profile", "span", "spanned", "Timer"]

#: what span() returns while no profiler runs (nullcontext is reentrant)
_OFF = contextlib.nullcontext()


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

    Besides torch's own ops and the card's kernels and copies, the trace
    holds the port's spans (:func:`span`, category ``user_annotation``),
    on the clock the device records share:

    ``spt.<frontend>``
        a whole frontend call (``spt.connectivityanalysis``,
        ``spt.freqanalysis``, ...), from its argument parsing to its
        result;
    ``spt.engine.initialize``
        the engine's plan: the selection, per-trial shapes, buckets and
        the host gather's plan;
    ``spt.engine.store_key``
        the device trial store's key (the selection's fingerprint) and its
        lookup, once per bucket on the host route;
    ``spt.engine.gather``, ``spt.engine.upload``
        one block's host gather and pad, then its host-to-device copy;
    ``spt.engine.resident``
        one chunk's rows taken from a device-resident input;
    ``spt.engine.dispatch``
        the launches of one trial shard's batch (spectra, kernels) and its
        auxiliary uploads;
    ``spt.engine.post``
        the fused normalization of a trial average;
    ``spt.engine.readback``
        a result's copy to the host, the host's wait for the queued device
        work included;
    ``spt.engine.finalize``
        the output's info, log, metadata and seal;
    ``spt.mesh.share_from``, ``spt.mesh.exchange``
        the host side of a transfer between ranks, the wait for the peers
        included;
    ``spt.granger.regularize``
        Granger's CSD regularization (the condition-number loading), of
        one CSD or shared by jackknife replicates;
    ``spt.granger.wilson``, ``spt.granger.wilson_twosided``
        one batched Wilson factorization on the device, one-sided, or the
        two-sided retry of what the one-sided form left unconverged;
    ``spt.granger.wilson_step``
        one step of either Wilson loop: its launches and its convergence
        test, which waits for them; its solve ``psi^-1 U`` is one launch
        of ``wilson_solve_kernel`` on a CUDA complex128 batch of at most
        256 channels, else ``inv_ex`` and a product, and
        ``ops/connectivity.py::wilson_counts()`` counts the steps' solves
        by route (``solve_kernel``, ``solve_library``);
    ``spt.granger.formula``
        the Granger-Geweke formula on the factors;
    ``spt.granger.host``
        the host float64 Granger path (regularization, Wilson and the
        formula in numpy), where the device route is gated off or both of
        its forms failed;
    ``spt.specest.cwt``
        one continuous wavelet transform (``ops/wavelet.py::cwt``, one a
        chunk of a wavelet freqanalysis): its bank uploads, transforms and
        power; ``ops/wavelet.py::cwt_counts()`` counts its calls, inverse
        transforms by bucket length and bank uploads.

    Read an idle stretch of the card's row by the innermost span or torch
    op open above it on the calling thread: under
    ``spt.engine.initialize`` the card waits for the engine's plan, under
    ``spt.engine.finalize`` for the output's metadata, under
    ``spt.mesh.share_from`` for a peer rank, and under a bare
    ``spt.<frontend>`` for the frontend's own Python.
    """
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


def span(name):
    """
    A context manager that marks its block as `name` in a running
    ``torch.profiler`` trace (:func:`profile`, or any other): a
    ``record_function`` span, nested under the span open around it on the
    same thread. With no profiler running it costs one read of
    ``torch.autograd.profiler._is_profiler_enabled``: no
    ``record_function`` is made and no time is taken. Spans are kept by
    the profiler and written when it stops.
    """
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def spanned(name):
    """Decorate a function so that each of its calls runs inside
    :func:`span` `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


class Timer:
    """Wall-clock context timer: ``with Timer() as t: ...; t.seconds``."""

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return False
