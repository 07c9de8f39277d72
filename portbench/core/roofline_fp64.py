"""The H100's published FP64 peak and the work of one step of Wilson's
factorization, for ``granger.wilson_roofline``.

A step of the one-sided iteration (``wilson_sf``) on F bins of (N, N)
complex128 matrices is one inverse and four products (``inv(psi) @ U``,
``g @ g^H``, ``psi @ (g+ + S)``, ``psi @ psi^H``); the inverse is charged as
one product, each product as 8 N^3 real FP64 operations a bin. Its bytes
are the step's complex128 (F, N, N) tensors read and written once: psi, U
and the CSD in, psi out. The two-sided retry works on 2F - 2 bins; it is
charged the one-sided form's work, the least the factorization needs.
"""

from .roofline import PEAK_HBM_BYTES

#: the H100 SXM's published FP64 tensor-core peak (NVIDIA's data sheet, 700 W)
PEAK_FP64_FLOPS = 67e12


def wilson_bound(F, N, steps):
    """(bound_ms, bound_by) of `steps` Wilson steps on F bins of N
    channels: the larger of the operations over the FP64 peak and the
    bytes over the HBM rate, per step, times the steps."""
    flops = 5 * 8 * N**3 * F
    nbytes = 4 * F * N * N * 16
    t_ops, t_bytes = flops / PEAK_FP64_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return steps * max(t_ops, t_bytes), by
