# -*- coding: utf-8 -*-
"""
One rank of a ``torch.distributed`` cluster that runs the port's frontends
on a mesh spanning every rank (the port's twin of
scripts/multihost_worker.py).

    python -m syncopy_tpu_torch.parallel.multihost_worker RANK WORLD PORT \\
        [--device cpu|cuda] [--backend gloo|nccl] [--size small|full] \\
        [--mesh TxC] [--positions K] [--timeout S] [--out DIR]

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

#: the small size: the AR(2) network's trials, samples, channels, seed
SMALL = (41, 256, 4, 8)
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
    print("MULTIHOST OK rank {}/{} mesh={}x{} positions={} backend={} device={}".format(
        rank, world, n_trial, n_chan, n_pos, dist.get_backend(), device), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
