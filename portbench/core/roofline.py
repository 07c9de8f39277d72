"""The H100's published peaks and the kernels' operation and byte counts.

Frozen copies of ``chip_smoke.py`` (``PEAK_FP32_FLOPS``/``PEAK_HBM_BYTES``
:274-276, ``bound`` :279, ``csd_bound`` :287, ``ppc_bound`` :294), so that a
change to the program cannot move the yardstick.
"""

#: the H100 SXM's published peaks (NVIDIA's data sheet, 700 W): FP32 outside
#: the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def bound(flops, nbytes):
    """(bound_ms, bound_by): the larger of operations over the FP32 peak
    and bytes (each input read once, each output written once) over the
    HBM rate."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def csd_bound(F, n, C):
    """The CSD kernels' bound: the upper triangle's 8 FP32 operations per
    (row, f, i <= j) against n complex64 rows in and (F, C, C) complex64
    out."""
    return bound(8 * F * n * C * (C + 1) / 2, F * n * C * 8 + F * C * C * 8)


def ppc_bound(F, n, K, C):
    """The PPC kernel's bound: per (trial, f, i <= j) term ~(8K + 6) FP32
    operations (the K-taper Gram, 8K; magnitude, IEEE sqrt and reciprocal,
    the scaled phasor into U, ~6: 30 at K = 3) against n * K complex64
    rows in and (F, C, C) complex64 out."""
    return bound((8 * K + 6) * F * n * C * (C + 1) / 2, F * n * K * C * 8 + F * C * C * 8)
