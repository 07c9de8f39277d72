# -*- coding: utf-8 -*-
"""
One rank of a ``torch.distributed`` cluster that runs the port's frontends
on a mesh spanning every rank (the port's twin of
scripts/multihost_worker.py).

    python -m syncopy_tpu_torch.parallel.multihost_worker RANK WORLD PORT \\
        [--device cpu|cuda] [--backend gloo|nccl] [--size small|full] \\
        [--mesh TxC] [--positions K] [--timeout S] [--out DIR] [--csd FILE]

Every rank joins through ``init_distributed`` (rank 0 serves the
rendezvous on ``localhost:PORT``) with K positions on its device
(``cuda:(rank % cards)`` or the CPU), builds ``make_mesh(T, C)`` over
the positions of every rank in rank order, makes the same data from a
seed and runs each frontend three ways: on that mesh, with
``parallel=False``, and on a one-process mesh of the same shape on its
own device. Each rank checks that its result

- is bitwise equal to rank 0's (rank 0 broadcasts it),
- is bitwise equal to the one-process mesh's (the same partial sums in
  the same order),
- lies within `TOL` of its own ``parallel=False`` result, relative to
  the larger of 1 and its maximum (bitwise for the band-pass, whose
  trials filter alone; `JACK_TOL` for the jackknife), and
- for coh, ppc, the band-pass and the timelock average, within `TOL` of
  a float64 oracle of the same math on its device (the band-pass: scipy
  on the first 16 trials);

and, on CUDA, that it launched the CSD, PPC and Butterworth kernels once
for each trial shard it owns per chunk, and no other kernel; on the CPU
the kernels' plain versions run and no launch is counted. It prints a
line for each frontend with those numbers, the bytes it sent and
received through the collectives, and the walls of the three routes
(medians of ``--reps`` more calls, taken in turns: the mesh call on
every rank together, then rank 0 alone on the one-process routes while
the others wait) and the same as one ``MULTIHOST {json}`` line, then
``MULTIHOST OK rank r/w ...``, and leaves the cluster. A failed check
raises: the rank exits non-zero and its peers fail in their next
collective, within the timeout.

``--size small`` runs coh, csd, ppc and granger at ``tapsmofrq=2``,
mtmfft with ``keeptrials=True``, the order-4 30-100 Hz Butterworth
band-pass, timelockanalysis with covariance and the coh jackknife on 41
trials x 256 samples x 4 channels of the seeded AR(2) network at 1 kHz,
chunks capped at 16 trials, so each call runs three chunks with a
ragged and, on four trial shards, empty shards. ``--size full`` runs
coh, ppc and the band-pass on the north-star data (1000 trials x 1000
samples x 64 channels at 1 kHz, float32 normal noise from seed 0).
``--out DIR`` writes each rank's results to ``DIR/rank<r>.npz``.

Then the ``sharded`` group runs the five sharded routines on the mesh's
trial axis: ``apply_fir_time_sharded``, ``mtmconvol_time_sharded``,
``cwt_time_sharded``, ``wilson_sf_sharded`` and ``granger_sharded``. Each
rank gathers the result (the halo'd routines' ``ShardedTensor.gather``)
and checks that it is bitwise equal to rank 0's and to its own one-process
mesh's, and within `HALO_TOL`, `WILSON_TOL` or `GRANGER_TOL` of the
unsharded function on its device, that the bytes it sent and received
in the routine and in the gather equal the count predicted from the
shapes, the mesh and, for Wilson, the step count (``Sharded.traffic``),
and that none of the port's kernels launched (these routines run cuFFT,
cuBLAS and cuSOLVER).
``--size small``: a (512, 4) recording of float32 noise (seed 3), an
order-8 low-pass FIR, 16-sample Hann windows (fourier, tapers kept), 3
Morlet(6) scales, and the 6-channel, 33-bin CSD of a seeded AR(2) network
(:func:`small_csd`); also Wilson on the CSD's first 3 channels (on four
positions: more positions than rows), Wilson on the channel axis (rank 1
owns none of its positions) and ``halo_exchange`` of halos as long as the
blocks. ``--size full``: chip_smoke.py phase 18d's shapes, a (250000, 64)
recording (seed 1), the order-400 8-12 Hz FIR, 64-sample Hann windows
(power), 30 Morlet(6) frequencies from 10 to 150 Hz, and the CSD of
``--csd FILE`` (``csd`` in an .npz). ``--out DIR`` writes the results to
``DIR/rank<r>_sharded.npz``, the rank's byte counts and halo blocks under
``local/``.
"""

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

#: bars: the mesh against parallel=False (relative to the larger of 1
#: and the maximum, so absolute for coherence and PPC; the band-pass
#: bitwise), and against float64 (absolute for coh and ppc; the
#: band-pass and the timelock average relative to the oracle's maximum)
TOL = 1e-6
F64_TOL = 1e-5
#: the coh jackknife's bar against parallel=False (that of
#: tests/test_torch_jackknife.py): jack_bias and jack_var carry the
#: replicates' rounding times nTrials - 1 (1.6e-6 at 41 trials on a
#: mesh with channel positions, in one process too)
JACK_TOL = 1e-5

#: the sharded routines' bars against the unsharded function (those of
#: tests/test_torch_sharding.py and chip_smoke.py phase 18d): the FIR,
#: STFT and CWT relative to the unsharded maximum, Wilson's H and Sigma
#: relative to the larger of 1 and the maximum (complex128), Granger
#: absolute
HALO_TOL, WILSON_TOL, GRANGER_TOL = 1e-5, 1e-8, 1e-6

#: granger_sharded's info values that the group saves, in this order
GRANGER_INFO = ("max rel. err", "reg. factor", "initial cond. num")

#: the small size: the AR(2) network's trials, samples, channels, seed
SMALL = (41, 256, 4, 8)
#: the sharded group's small recording (samples, channels, seed) and CSD
#: (channels, samples a trial, trials, seed: 33 one-sided bins)
SMALL_RECORDING, SMALL_CSD = (512, 4, 3), (6, 64, 40, 0)
#: the sharded group's full recording: chip_smoke.py phase 18d's
FULL_RECORDING = (250000, 64, 1)
#: the full size: the north-star shape
FULL = (1000, 1000, 64)
FS = 1000.0

#: the kernel each frontend's first compute routine launches on a card,
#: and whether that routine sums trials in one fused pass (then every
#: shard launches, an all-padding one too)
KERNELS = {"coh": ("csd_accumulate_tiled", True), "csd": ("csd_accumulate_tiled", True),
           "ppc": ("ppc_accumulate_tiled", True), "bandpass": ("sosfiltfilt", False)}


def small_data(spt):
    n_trials, n_samples, n_chan, seed = SMALL
    adj = np.zeros((n_chan, n_chan))
    adj[0, 1] = adj[2, 3] = 0.25
    return spt.synthdata.ar2_network(nTrials=n_trials, AdjMat=adj, nSamples=n_samples,
                                     seed=seed)


def full_data(spt):
    n_trials, n_samples, n_chan = FULL
    rng = np.random.default_rng(0)
    data = rng.normal(size=(n_trials * n_samples, n_chan)).astype("f4")
    trl = np.zeros((n_trials, 3))
    trl[:, 0] = np.arange(n_trials) * n_samples
    trl[:, 1] = trl[:, 0] + n_samples
    return spt.from_arrays(data, trl, FS)


def frontends(spt, size):
    """``{name: call}``; each call takes ``**kwargs`` for the frontend
    (``parallel``) and returns ``{key: numpy array}``."""

    def conn(method, **cfg):
        def call(adata, **kw):
            out = spt.connectivityanalysis(adata, method=method, tapsmofrq=2, **cfg, **kw)
            res = {"data": np.asarray(out.data)}
            if cfg.get("jackknife"):
                res["jack_var"] = np.asarray(out._get_extra_dataset("jack_var"))
                res["jack_bias"] = np.asarray(out._get_extra_dataset("jack_bias"))
            return res
        return call

    def bandpass(adata, **kw):
        return {"data": np.asarray(spt.preprocessing(
            adata, filter_class="but", filter_type="bp", freq=[30, 100], order=4,
            keeptrials=True, **kw).data)}

    def mtmfft(adata, **kw):
        return {"data": np.asarray(spt.freqanalysis(
            adata, method="mtmfft", tapsmofrq=2, keeptrials=True, **kw).data)}

    def timelock(adata, **kw):
        out = spt.timelockanalysis(adata, covariance=True, **kw)
        return {"avg": np.asarray(out.avg), "var": np.asarray(out.var),
                "cov": np.asarray(out.cov)}

    calls = {"coh": conn("coh"), "ppc": conn("ppc"), "bandpass": bandpass}
    if size == "small":
        calls.update(csd=conn("csd"), granger=conn("granger"), mtmfft=mtmfft,
                     timelock=timelock, coh_jackknife=conn("coh", jackknife=True))
    return calls


def small_csd(spt):
    """The trial-averaged Hann CSD (complex128 numpy) of a seeded AR(2)
    network of `SMALL_CSD`'s shape, as tests/test_torch_sharding.py makes
    its CSDs."""
    n_chan, n_samples, n_trials, seed = SMALL_CSD
    adj = spt.synthdata.mk_RandomAdjMat(n_chan, conn_thresh=0.8, max_coupling=0.15, seed=seed)
    adj = adj / max(1.0, 3 * np.abs(np.linalg.eigvals(adj)).max())
    ad = spt.synthdata.ar2_network(AdjMat=adj, nTrials=n_trials, nSamples=n_samples, seed=seed)
    x = np.stack([np.asarray(ad.trials[k], dtype=np.float64) for k in range(n_trials)])
    X = np.fft.rfft(np.hanning(n_samples)[None, :, None] * (x - x.mean(axis=1, keepdims=True)),
                    axis=1)
    return np.einsum("bfi,bfj->fij", X, X.conj()) / n_trials


class Sharded:
    """One sharded routine of the group: ``run(mesh)`` calls it (the
    collectives of the call), ``whole(raw, device)`` makes every rank hold
    the whole result as ``{key: tensor}`` (the gather), ``plain(device)``
    gives the unsharded function's values of the keys it returns,
    ``tol``/``rel`` the bar (relative to the larger of 1 and the maximum
    with ``rel="one"``, to the maximum with ``rel="max"``, absolute with
    None); ``traffic(ranks, rank, world, got, twin)`` the predicted
    (routine sent, received, gather sent, received) bytes of `rank` on the
    axis's owner `ranks`, from the shapes and `got`'s step count (`twin`:
    the one-process mesh of the same shape)."""

    def __init__(self, run, whole, plain, tol, rel, traffic):
        self.run, self.whole, self.plain = run, whole, plain
        self.tol, self.rel, self.traffic = tol, rel, traffic


def _bytes(moves, rank):
    """`rank`'s (sent, received) bytes over ``(src, dst, nbytes)`` moves."""
    return (sum(n for s, d, n in moves if s == rank != d),
            sum(n for s, d, n in moves if d == rank != s))


def halo_moves(ranks, left, right, row_bytes):
    """The halos' ``(src, dst, nbytes)``: each block's left halo from its
    left neighbour, its right one from its right neighbour."""
    n = len(ranks)
    return ([(ranks[i - 1], ranks[i], left * row_bytes) for i in range(1, n)]
            + [(ranks[i + 1], ranks[i], right * row_bytes) for i in range(n - 1)])


def gather_moves(ranks, block_bytes, world):
    """ShardedTensor.gather's (mesh.replicate): each block from its owner
    to every other rank."""
    return [(src, r, n) for src, n in zip(ranks, block_bytes) for r in range(world) if r != src]


def wilson_moves(ranks, F, N, n_iter, world, itemsize=16):
    """wilson_sf_sharded's on a mesh that spans processes: the setup (each
    frequency block's CSD, valid bins and psi0 from the first position),
    per step the two layout swaps, the zero-lag rows to the first
    position, its correction back and each frequency block's error (a
    real scalar) to every other rank, then the inverse to every block, the
    gather of Hfunc and Sigma to every other rank."""
    from .mesh import split_sizes

    f, r = split_sizes(F, len(ranks)), split_sizes(N, len(ranks))
    freq = [p for p in range(len(ranks)) if f[p]]
    rows = [q for q in range(len(ranks)) if r[q]]
    home, mat = ranks[0], N * N * itemsize
    setup = [(home, ranks[p], f[p] * mat + f[p] + mat) for p in freq]
    swap = [(ranks[p], ranks[q], f[p] * r[q] * N * itemsize) for q in rows for p in freq]
    step = (swap + [(b, a, n) for a, b, n in swap]
            + [(ranks[q], home, r[q] * N * itemsize) for q in rows]
            + [(home, ranks[p], mat) for p in freq]
            + gather_moves([ranks[p] for p in freq], [itemsize // 2] * len(freq), world))
    end = ([(home, ranks[p], mat) for p in freq]
           + gather_moves([ranks[p] for p in freq], [f[p] * mat for p in freq], world)
           + [(home, b, mat) for b in range(world) if b != home])
    return setup + step * n_iter + end


def sharded_cases(spt, size, device, csd=None):
    """The sharded group's routines at `size` on `device`: ``{name:
    Sharded}``; the full size takes `csd` (complex128 numpy)."""
    from ..ops import connectivity as pc
    from ..ops import filtering as pf
    from ..ops import stft as ps
    from ..ops import wavelet as pw
    from ..ops.windows import make_tapers

    if size == "small":
        T, C, seed = SMALL_RECORDING
        fir = pf.design_wsinc("hamming", 8, 0.1, "lp")
        nperseg, output, keeptapers = 16, "fourier", True
        scales = np.array([0.005, 0.01, 0.02])
        csd = small_csd(spt)
    else:
        T, C, seed = FULL_RECORDING
        fir = pf.design_wsinc("hamming", 400, np.array([8.0, 12.0]) / FS, "bp")
        nperseg, output, keeptapers = 64, "pow", False
        scales = pw.Morlet(6).scale_from_period(1.0 / np.linspace(10.0, 150.0, 30))
        if csd is None:
            raise ValueError("--size full runs Wilson and Granger on the CSD of --csd FILE")
    x = np.random.default_rng(seed).normal(size=(T, C)).astype("f4")
    x_dev = torch.from_numpy(x).to(device)
    tapers = torch.from_numpy(make_tapers("hann", None, nperseg, nperseg, FS))
    dt = 1.0 / FS
    csd = torch.from_numpy(csd)

    def halo_case(run, plain, left, right, out_bytes):
        """A halo'd routine: `out_bytes` is its output's bytes per sample."""
        def traffic(ranks, rank, world, got, twin):
            blocks = [T // len(ranks) * out_bytes] * len(ranks)
            return _bytes(halo_moves(ranks, left, right, C * 4), rank) + _bytes(
                gather_moves(ranks, blocks, world), rank)
        return Sharded(run, lambda raw, dev: {"data": raw.gather(dev)}, plain, HALO_TOL, "max",
                       traffic)

    def wilson_case(C_in, axis):
        def run(mesh):
            return pc.wilson_sf_sharded(C_in, mesh=mesh, axis_name=axis)

        def whole(raw, dev):
            return dict(zip(["H", "Sigma", "converged", "err", "n_iter"], raw))

        def plain(dev):
            H, Sigma = pc.wilson_sf(C_in.to(dev))[:2]
            return {"H": H, "Sigma": Sigma}

        def traffic(ranks, rank, world, got, twin):
            moves = wilson_moves(ranks, C_in.shape[0], C_in.shape[-1], int(got["n_iter"]), world)
            return _bytes(moves, rank) + (0, 0)
        return Sharded(run, whole, plain, WILSON_TOL, "one", traffic)

    def granger_whole(raw, dev):
        G, info = raw
        return {"G": G, "converged": torch.tensor(info["converged"]),
                "info": torch.tensor([info[k] for k in GRANGER_INFO], dtype=torch.float64)}

    def granger_plain(dev):
        reg, factor, ini_cn = pc.regularize_csd(csd.to(dev), cond_max=1e4, eps_max=1e-1)
        H, Sigma, conv, err, _ = pc.wilson_sf(reg, nIter=100, rtol=5e-6)
        return {"G": pc.granger(reg, H, Sigma)}

    def granger_traffic(ranks, rank, world, got, twin):
        # Wilson inside takes the steps it takes on the one-process mesh;
        # then G and the two regularization numbers to every other rank
        reg = pc.regularize_csd(csd.to(twin.home_device()), cond_max=1e4, eps_max=1e-1)[0]
        n_iter = int(pc.wilson_sf_sharded(reg, mesh=twin, nIter=100, rtol=5e-6)[4])
        F, N = csd.shape[0], csd.shape[-1]
        moves = wilson_moves(ranks, F, N, n_iter, world)
        moves += [(ranks[0], b, F * N * N * 8 + 16) for b in range(world) if b != ranks[0]]
        return _bytes(moves, rank) + (0, 0)

    n_spec = (tapers.shape[0] if keeptapers else 1) * (nperseg // 2 + 1) * (8 if output ==
                                                                             "fourier" else 4)
    cases = {
        "apply_fir_time_sharded": halo_case(
            lambda mesh: pf.apply_fir_time_sharded(x_dev, fir, mesh),
            lambda dev: {"data": pf.apply_fir(x_dev[None], fir)[0]},
            (len(fir) - 1) // 2, (len(fir) - 1) // 2, C * 4),
        "mtmconvol_time_sharded": halo_case(
            lambda mesh: ps.mtmconvol_time_sharded(x_dev, tapers, nperseg, mesh, output=output,
                                                   keeptapers=keeptapers),
            lambda dev: {"data": ps.mtmconvol(x_dev[None], tapers, nperseg, hop=1, n_time=T,
                                              output=output, keeptapers=keeptapers)[0]},
            nperseg // 2, nperseg - nperseg // 2, n_spec * C),
        "cwt_time_sharded": halo_case(
            lambda mesh: pw.cwt_time_sharded(x_dev, pw.Morlet(6), scales, dt, mesh),
            lambda dev: {"data": pw.cwt(x_dev, pw.Morlet(6), scales, dt)},
            int(np.ceil(5.0 * scales.max() / dt)) + 1, int(np.ceil(5.0 * scales.max() / dt)) + 1,
            len(scales) * C * 8),
        "wilson_sf_sharded": wilson_case(csd, "trial"),
        "granger_sharded": Sharded(lambda mesh: pc.granger_sharded(csd, mesh=mesh),
                                   granger_whole, granger_plain, GRANGER_TOL, None,
                                   granger_traffic),
    }
    if size == "small":
        cases["wilson_sf_sharded_3ch"] = wilson_case(csd[:, :3, :3].contiguous(), "trial")
        cases["wilson_sf_sharded_channel_axis"] = wilson_case(csd, "channel")
    return cases


def trials_of(adata):
    """The (nTrials, nSamples, nChannels) float64 batch of equal trials."""
    si = adata.sampleinfo
    n = int(si[0, 1] - si[0, 0])
    return np.asarray(adata.data, dtype=np.float64).reshape(len(si), n, -1)


def oracle(name, adata, device):
    """The float64 result of the same math on `device`, or None where
    this worker has none: coh and ppc (demean, the port's taper bank,
    rfft, trial x taper CSD sum, normalization or unit phasor), the
    band-pass (scipy on the first 16 trials), the timelock average."""
    from ..ops.windows import make_tapers
    from ..shared.input_processors import process_taper

    x = trials_of(adata)
    if name == "bandpass":
        from scipy import signal

        from ..ops.filtering import butter_sos
        from ..ops.iir_kernels import sosfilt_padlen

        sos = butter_sos(4, [30.0, 100.0], "bp", FS)
        return signal.sosfiltfilt(sos, x[:16], axis=1, padlen=sosfilt_padlen(sos, x.shape[1]))
    if name == "timelock":
        return x.mean(axis=0)
    if name not in ("coh", "ppc"):
        return None
    n_trials, n_samples, n_chan = x.shape
    taper, taper_opt = process_taper("hann", None, 2, None, keeptapers=False, foimax=FS / 2,
                                     samplerate=FS, nSamples=n_samples, output="pow")
    tapers = torch.from_numpy(make_tapers(taper, taper_opt, n_samples, n_samples, FS)).to(
        device, torch.float64)
    acc = torch.zeros((n_samples // 2 + 1, n_chan, n_chan), dtype=torch.complex128,
                      device=device)
    for b0 in range(0, n_trials, 50):
        xb = torch.from_numpy(x[b0 : b0 + 50]).to(device)
        xb = xb - xb.mean(dim=1, keepdim=True)
        spec = torch.fft.rfft(tapers[None, :, :, None] * xb[:, None], n=n_samples, dim=2)
        cs = torch.matmul(spec.permute(0, 2, 3, 1), spec.conj().permute(0, 2, 1, 3))
        if name == "coh":
            acc += cs.sum(dim=0)
        else:
            mag = cs.abs()
            acc += torch.where(mag > 0, cs / torch.where(mag > 0, mag, 1.0), 0).sum(dim=0)
    if name == "coh":
        diag = torch.diagonal(acc, dim1=-2, dim2=-1).real
        return (acc.abs() / torch.sqrt(diag[:, :, None] * diag[:, None, :])).cpu().numpy()
    return ((acc.abs() ** 2 - n_trials) / (n_trials * (n_trials - 1))).cpu().numpy()


def routines_of(fn):
    """`fn()` and the compute routines it initialized, in order."""
    from ..engine.routine import ComputationalRoutine

    routines, initialize = [], ComputationalRoutine.initialize

    def keep(self, *args, **kwargs):
        routines.append(self)
        return initialize(self, *args, **kwargs)

    ComputationalRoutine.initialize = keep
    try:
        return fn(), routines
    finally:
        ComputationalRoutine.initialize = initialize


def kernel_counters():
    from ..ops import csd_kernels, iir_kernels, ppc_kernels

    return {"csd_accumulate_tiled": csd_kernels.csd_accumulate_tiled,
            "csd_accumulate": csd_kernels.csd_accumulate,
            "ppc_accumulate_tiled": ppc_kernels.ppc_accumulate_tiled,
            "sosfiltfilt": iir_kernels.sosfilt_batch}


def own_launches(cr, fused, mesh, rank):
    """The launches a routine's chunk plan asks of this rank: each trial
    shard it owns per chunk (one that holds rows, unless fused)."""
    owned = mesh.ranks[:, 0] == rank
    return sum(1 for p in cr.chunk_plan for rows in p["shard_rows"]
               for i, nv in enumerate(rows) if owned[i] and (fused or nv > 0))


def synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bitwise(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def same_bits(a, b):
    """Whether tensors `a` and `b` hold the same shape, dtype and bytes."""
    def raw(t):
        return t.detach().contiguous().reshape(-1).view(torch.uint8)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(raw(a), raw(b).to(a.device))


def sharded_diff(got, want, rel):
    """max|got - want| over the larger of 1 and max|want| (`rel` "one"),
    over max|want| ("max") or absolute (None), in float64 on `want`'s
    device."""
    d = (got.to(want.device, torch.complex128) - want.to(torch.complex128)).abs().max().item()
    scale = want.abs().max().item()
    return d / {"one": max(scale, 1.0), "max": scale, None: 1.0}[rel]


def max_diff(a, b):
    d = np.abs(a.astype(np.complex128) - b.astype(np.complex128))
    return float(np.nanmax(d)) if d.size else 0.0


def rel_diff(a, b):
    """max|a - b| over the larger of 1 and max|b|."""
    return max_diff(a, b) / max(float(np.nanmax(np.abs(b))) if b.size else 0.0, 1.0)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("rank", type=int)
    parser.add_argument("world", type=int)
    parser.add_argument("port", type=int)
    parser.add_argument("--device", choices=["cpu", "cuda"], default="cuda")
    parser.add_argument("--backend", choices=["gloo", "nccl"], default=None,
                        help="default: nccl on cuda, gloo on the cpu")
    parser.add_argument("--size", choices=["small", "full"], default="small")
    parser.add_argument("--mesh", default=None, metavar="TxC",
                        help="trial x channel positions; default: every position x 1")
    parser.add_argument("--positions", type=int, default=1, metavar="K",
                        help="mesh positions of each rank, all on its device")
    parser.add_argument("--timeout", type=float, default=120.0, metavar="S")
    parser.add_argument("--reps", type=int, default=1, help="timed calls of each route")
    parser.add_argument("--out", default=None, metavar="DIR")
    parser.add_argument("--csd", default=None, metavar="FILE",
                        help="the full size's Wilson and Granger CSD (`csd` in an .npz)")
    args = parser.parse_args(argv)

    import syncopy_tpu_torch as spt
    from ..engine import routine
    from . import mesh as pmesh

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda but no CUDA device is available")
        device = torch.device("cuda", args.rank % torch.cuda.device_count())
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    spt.set_device(device)
    if args.size == "small":
        routine.MAX_CHUNK_TRIALS = 16
    rank, world = args.rank, args.world
    spt.init_distributed(coordinator_address="localhost:{}".format(args.port),
                         num_processes=world, process_id=rank, backend=args.backend,
                         local_devices=[device] * args.positions, timeout=args.timeout)
    dist = torch.distributed
    n_pos = world * args.positions
    n_trial, n_chan = (n_pos, 1) if args.mesh is None else map(int, args.mesh.split("x"))
    mesh = spt.make_mesh(n_trial=n_trial, n_channel=n_chan)
    twin = spt.make_mesh(n_trial=n_trial, n_channel=n_chan, devices=[device] * n_pos)
    if mesh.devices.size != n_pos or not mesh.crosses_processes:
        raise AssertionError("the mesh does not span the cluster: {!r}".format(mesh))
    adata = small_data(spt) if args.size == "small" else full_data(spt)
    counters = kernel_counters()
    saved = {}
    print("rank {}/{}: {!r} on {} over {}".format(rank, world, mesh, device,
                                                  dist.get_backend()), flush=True)

    def timed(call, alone):
        """Wall of one call with an empty trial store, every rank
        starting together; `alone` runs it on rank 0 only (None
        elsewhere)."""
        routine.clear_device_cache()
        dist.barrier()
        wall = None
        if rank == 0 or not alone:
            synchronize(device)
            t0 = time.perf_counter()
            call()
            synchronize(device)
            wall = time.perf_counter() - t0
        dist.barrier()
        return wall

    for name, call in frontends(spt, args.size).items():
        # -- the checked call on the mesh that spans the ranks
        routine.clear_device_cache()
        for c in counters.values():
            c.launches = 0
        pmesh.reset_collective_counts()
        dist.barrier()
        t0 = time.perf_counter()
        with spt.use_mesh(mesh):
            got, crs = routines_of(lambda: call(adata))
        synchronize(device)
        first = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        moved = pmesh.collective_counts()
        want = dict.fromkeys(counters, 0)
        if device.type == "cuda" and name in KERNELS:
            kernel, fused = KERNELS[name]
            want[kernel] = own_launches(crs[0], fused, mesh, rank)
        if launches != want:
            raise AssertionError("rank {} {}: launches {}, expected {}".format(
                rank, name, launches, want))

        # -- rank 0's result, the one-process routes and float64
        ref = {k: pmesh.share_from(torch.from_numpy(v) if rank == 0 else None, 0, "cpu")[0]
               .numpy() for k, v in got.items()}
        solo = call(adata, parallel=False)
        with spt.use_mesh(twin):
            local = call(adata)
        for k, v in got.items():
            if not bitwise(v, ref[k]):
                raise AssertionError("rank {} {} {}: not bitwise equal to rank 0's".format(
                    rank, name, k))
            if not bitwise(v, local[k]):
                raise AssertionError("rank {} {} {}: not bitwise equal to the one-process "
                                     "mesh's (max diff {:.3e})".format(
                                         rank, name, k, max_diff(v, local[k])))
        diff = max(rel_diff(v, solo[k]) for k, v in got.items())
        exact = name == "bandpass"
        if not (diff == 0 if exact else diff <= (JACK_TOL if "jackknife" in name else TOL)):
            raise AssertionError("rank {} {}: {:.3e} from parallel=False".format(rank, name, diff))
        want64 = oracle(name, adata, device)
        err64 = None
        if want64 is not None:
            head = got["avg"] if name == "timelock" else got["data"]
            if name == "coh" or name == "ppc":
                err64 = max_diff(head[0], want64)
            else:
                head = head if name == "timelock" else head[: want64.shape[0] * want64.shape[1]]
                err64 = max_diff(head.reshape(want64.shape), want64) / np.abs(want64).max()
            if not err64 <= F64_TOL:
                raise AssertionError("rank {} {}: {:.3e} from float64".format(rank, name, err64))

        # -- walls, in turns
        walls = {"mesh": [], "parallel=False": [], "one-process mesh": []}
        for _ in range(args.reps):
            def on_mesh(m):
                with spt.use_mesh(m):
                    call(adata)
            walls["mesh"].append(timed(lambda: on_mesh(mesh), False))
            walls["parallel=False"].append(timed(lambda: call(adata, parallel=False), True))
            walls["one-process mesh"].append(timed(lambda: on_mesh(twin), True))
        wall_text = ", ".join("{} {}".format(k, "median {:.4f} s ({})".format(
            statistics.median(v), ", ".join("{:.4f}".format(w) for w in v))
            if v and v[0] is not None else "not timed on this rank") for k, v in walls.items())
        print("rank {}/{} {}: launches {}; shard rows {}; bitwise equal to rank 0 and to the "
              "one-process mesh; max diff to parallel=False {:.3e}{}; collectives sent {} B, "
              "received {} B; first call {:.4f} s; walls: {}".format(
                  rank, world, name, {k: v for k, v in launches.items() if v} or "none",
                  crs[0].chunk_plan[0]["shard_rows"], diff,
                  "" if err64 is None else ", to float64 {:.3e}".format(err64),
                  moved["sent"], moved["received"], first, wall_text), flush=True)
        print("MULTIHOST " + json.dumps({
            "rank": rank, "world": world, "frontend": name, "launches": launches,
            "max_diff": diff, "err_f64": err64, "sent": moved["sent"],
            "received": moved["received"], "first_s": first, "walls_s": walls}), flush=True)
        saved.update({"{}/{}".format(name, k): v for k, v in got.items()})

    if args.out:
        np.savez("{}/rank{}.npz".format(args.out, rank), **saved)
    del adata
    csd = None if args.csd is None else np.load(args.csd)["csd"]
    sharded_group(spt, args, mesh, twin, device, timed, csd)
    print("MULTIHOST OK rank {}/{} mesh={}x{} positions={} backend={} device={}".format(
        rank, world, n_trial, n_chan, n_pos, dist.get_backend(), device), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def sharded_group(spt, args, mesh, twin, device, timed, csd):
    """The sharded routines on `mesh` (over the ranks) and `twin` (one
    process, the same shape); see the module's docstring."""
    from . import mesh as pmesh

    dist = torch.distributed
    rank, world = args.rank, args.world
    saved = {}
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    for name, case in sharded_cases(spt, args.size, device, csd).items():
        axis = "channel" if name.endswith("channel_axis") else "trial"
        ranks = pmesh.axis_ranks(mesh, axis)
        # -- the checked call, then the gather, each with its bytes
        pmesh.reset_collective_counts()
        dist.barrier()
        t0 = time.perf_counter()
        raw = case.run(mesh)
        synchronize(device)
        routine_bytes = pmesh.collective_counts()
        got = case.whole(raw, device)
        synchronize(device)
        first = time.perf_counter() - t0
        total = pmesh.collective_counts()
        moved = (routine_bytes["sent"], routine_bytes["received"],
                 total["sent"] - routine_bytes["sent"],
                 total["received"] - routine_bytes["received"])
        del raw
        want = case.traffic(ranks, rank, world, got, twin)
        if moved != want:
            raise AssertionError("rank {} {}: bytes sent, received in the routine and the "
                                 "gather {}, predicted {}".format(rank, name, moved, want))
        for k, v in got.items():
            ref = pmesh.share_from(v if rank == 0 else None, 0, device)[0]
            if not same_bits(v, ref):
                raise AssertionError("rank {} {} {}: not bitwise equal to rank 0's".format(
                    rank, name, k))
            del ref
        local = case.whole(case.run(twin), device)
        for k, v in got.items():
            if not same_bits(v, local[k]):
                raise AssertionError("rank {} {} {}: not bitwise equal to the one-process "
                                     "mesh's".format(rank, name, k))
        del local
        plain = case.plain(device)
        diff = max(sharded_diff(got[k], v, case.rel) for k, v in plain.items())
        del plain
        if not diff <= case.tol or ("converged" in got and not bool(got["converged"])):
            raise AssertionError("rank {} {}: {:.3e} from the unsharded function (bar {}), "
                                 "converged {}".format(rank, name, diff, case.tol,
                                                       got.get("converged")))
        steps = int(got["n_iter"]) if "n_iter" in got else None
        if args.out:
            saved.update({"{}/{}".format(name, k): v.cpu().numpy() for k, v in got.items()})
            saved["local/{}/bytes".format(name)] = np.array(moved)
        del got
        if device.type == "cuda":
            torch.cuda.empty_cache()

        # -- walls, in turns
        walls = {"mesh": [], "unsharded": [], "one-process mesh": []}
        for _ in range(args.reps):
            walls["mesh"].append(timed(lambda: case.whole(case.run(mesh), device), False))
            walls["unsharded"].append(timed(lambda: case.plain(device), True))
            walls["one-process mesh"].append(timed(lambda: case.whole(case.run(twin), device),
                                                   True))
        wall_text = ", ".join("{} {}".format(k, "median {:.4f} s ({})".format(
            statistics.median(v), ", ".join("{:.4f}".format(w) for w in v))
            if v and v[0] is not None else "not timed on this rank") for k, v in walls.items())
        print("rank {}/{} {}: bitwise equal to rank 0 and to the one-process mesh; max diff to "
              "the unsharded function {:.3e} (bar {}){}; bytes sent / received in the routine "
              "{} / {}, in the gather {} / {} (as predicted); first call {:.4f} s; walls: "
              "{}".format(rank, world, name, diff, case.tol,
                          "" if steps is None else "; {} steps".format(steps), *moved, first,
                          wall_text), flush=True)
        print("MULTIHOST " + json.dumps({
            "rank": rank, "world": world, "routine": name, "max_diff": diff, "tol": case.tol,
            "steps": steps, "bytes": moved, "predicted": want, "first_s": first,
            "walls_s": walls}), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()

    launches = {k: c.launches for k, c in counters.items() if c.launches}
    if launches:
        raise AssertionError("rank {}: the sharded routines launched {}".format(rank, launches))
    if args.size == "small":
        # halos as long as the blocks, between positions of one rank and of two
        x = torch.arange(16 * 3, dtype=torch.float32).reshape(16, 3)
        devices = pmesh.axis_devices(mesh, "trial")
        ranks = pmesh.axis_ranks(mesh, "trial")
        n = 16 // len(devices)
        blocks = pmesh.split_along(x, devices, ranks=ranks)
        for i, ext in enumerate(pmesh.halo_exchange(blocks, n, n, ranks)):
            if ext is not None:
                saved["local/halo_exchange/{}".format(i)] = ext.cpu().numpy()
    if args.out:
        np.savez("{}/rank{}_sharded.npz".format(args.out, rank), **saved)


if __name__ == "__main__":
    sys.exit(main())
