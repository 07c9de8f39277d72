"""One run of one cell: set-up, the measured window, the check of what the
window produced, the trace's reduction, and the result's line.

A configuration names, for each of its call kinds, the program's frontend
(an attribute of ``syncopy_tpu_torch``), its keyword arguments and the
reference that judges its results; nothing here knows a method. A
configuration with ``ranks`` > 1 runs as that many processes, one card
each, joined by ``init_distributed`` (NCCL on the cards) on a trial mesh
over the ranks. The process that was started is rank 0: it starts the
others, decides when the window closes, and prints the result. Every call
is collective and closed-loop: the next starts when the previous result is
on the host of every rank.
"""

import contextlib
import gc
import importlib
import importlib.util
import os
import random
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from . import guard, manifest
from .trace import Trace
from .traffic import Plan

#: seconds a rank waits for its peers, to join and in every collective
RANK_TIMEOUT = 120
#: seconds rank 0 waits for the other ranks to exit after its result
CHILD_EXIT_TIMEOUT = 60


class Options:
    """One run's arguments: ``workload``, ``seed``, ``seconds``, ``trace``,
    and, for the harness's own use, ``device`` ("cuda", or "cpu" for the
    tests), ``fault`` (tests only), ``rank``, ``world``, ``port``,
    ``t_start`` (the process's start on the host clock), ``root`` and
    ``bench_dir``."""

    def __init__(self, **kw):
        self.device, self.fault, self.rank, self.world, self.port = "cuda", None, 0, None, None
        self.root, self.bench_dir, self.t_start = manifest.ROOT, manifest.BENCH_DIR, None
        self.__dict__.update(kw)


def load_file(path, name):
    spec = importlib.util.spec_from_file_location(name, str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def main(opts):
    """Run the cell; returns the process's exit code."""
    bench = manifest.load(opts.root)
    cell, config, mix, e2e, layer = manifest.resolve(bench, opts.workload, opts.bench_dir,
                                                     opts.root)
    world = int(config.get("ranks", 1))
    import torch

    if opts.device == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < cell["chips"]):
        print("portbench: cell {} needs {} CUDA card(s); torch sees {}".format(
            cell["name"], cell["chips"],
            torch.cuda.device_count() if torch.cuda.is_available() else "none"), file=sys.stderr)
        return 3
    children = []
    if world > 1 and opts.rank == 0:
        opts.port = free_port()
        children = spawn(opts, world)
    ok = False
    try:
        stats = run_rank(opts, cell, config, mix, layer, world)
        ok = True
    finally:
        for p in children:
            try:
                p.wait(timeout=CHILD_EXIT_TIMEOUT if ok else 5)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    if opts.rank != 0:
        return 0
    bad = [p.returncode for p in children if p.returncode != 0]
    if bad:
        print("portbench: a rank exited with {}".format(bad), file=sys.stderr)
        return 1
    return report(stats, cell, config, e2e, layer, world, opts.device == "cuda")


def spawn(opts, world):
    """Ranks 1 .. world - 1 of this run, each a process of run.py; their
    output goes to this process's standard error."""
    cmd = [sys.executable, str(Path(opts.bench_dir) / "run.py"), "--workload", opts.workload,
           "--seed", str(opts.seed), "--seconds", str(opts.seconds), "--trace", str(opts.trace),
           "--device", opts.device, "--world", str(world), "--port", str(opts.port)]
    if opts.fault:
        cmd += ["--fault", opts.fault]
    return [subprocess.Popen(cmd + ["--rank", str(r)], cwd=str(opts.root), stdout=sys.stderr,
                             stderr=sys.stderr) for r in range(1, world)]


def time_library_loads(spt, spent):
    """Wrap the program's library loader (``load_library`` wherever a module
    of the program holds it) so that `spent["s"]` adds the seconds of every
    load: the nvcc build on a checkout's first run, else the ``dlopen``."""
    def timed(real):
        def load_library(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real(*a, **kw)
            finally:
                spent["s"] += time.perf_counter() - t0

        load_library._portbench_timed = True
        return load_library

    for name, mod in list(sys.modules.items()):
        fn = getattr(mod, "load_library", None) if name.split(".", 1)[0] == spt.__name__ else None
        if callable(fn) and not getattr(fn, "_portbench_timed", False):
            setattr(mod, "load_library", timed(fn))


def run_rank(opts, cell, config, mix, layer, world):
    """Set-up, window and check on this rank; returns its statistics."""
    import torch

    import syncopy_tpu_torch as spt

    home = os.path.join(os.path.abspath(opts.root), "syncopy_tpu_torch")
    if os.path.dirname(os.path.abspath(spt.__file__)) != home:
        raise RuntimeError("syncopy_tpu_torch came from {}, not from the checkout ({})".format(
            spt.__file__, home))
    with contextlib.suppress(ImportError):  # the loader's module, before its users import it
        importlib.import_module("syncopy_tpu_torch.ops._nvcc")
    library_s = {"s": 0.0}
    time_library_loads(spt, library_s)
    from syncopy_tpu_torch.engine import routine
    from syncopy_tpu_torch.parallel import mesh as pmesh

    rank, cuda = opts.rank, opts.device == "cuda"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(max(1, min(4, (os.cpu_count() or 1) // world)))
    spt.set_device(dev)
    mesh = None
    if world > 1:
        spt.init_distributed(coordinator_address="localhost:{}".format(opts.port),
                             num_processes=world, process_id=rank,
                             backend="nccl" if cuda else "gloo", local_devices=[dev],
                             timeout=RANK_TIMEOUT)
        mesh = spt.make_mesh(n_trial=world)
    dist = torch.distributed if world > 1 else None

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    # -- data from the seed, made on the card, held on the host
    t_data = time.perf_counter()
    plan = Plan(config, mix)
    gen = importlib.import_module("portbench.datagen." + config["generator"])
    pool = [gen.make(config, opts.seed, k, dev) for k in range(plan.n_datasets)]
    trl = gen.trialdefinition(config)
    adatas = [spt.from_arrays(p, trl, config["samplerate"]) for p in pool]
    sync()
    t_data = time.perf_counter() - t_data
    if opts.fault:
        from . import faults

        faults.install(opts.fault, spt, config, pool, trl)

    # -- what each call did: the routines it initialized (with the engine's
    # bytes at that moment), its payload's source and blocks
    seen = []
    initialize = routine.ComputationalRoutine.initialize

    def watch(self, *a, **kw):
        seen.append((self, routine.transfer_counts()["h2d"]))
        return initialize(self, *a, **kw)

    routine.ComputationalRoutine.initialize = watch
    owned = [True] if mesh is None else list(mesh.ranks[:, 0] == rank)
    calls = config["calls"]
    refs = {kind: importlib.import_module("portbench.reference." + calls[kind]["reference"])
            for kind in plan.warm_kinds()}

    def one_call(i, kind, k):
        call = calls[kind]
        if plan.clear_store:
            spt.clear_device_cache()
        n0, h0 = len(seen), routine.transfer_counts()["h2d"]
        c0 = pmesh.collective_counts() if mesh is not None else None
        label = contextlib.nullcontext() if not opts.trace else \
            torch.profiler.record_function("portbench.call.{}".format(i))
        frontend = getattr(spt, call["frontend"])
        t0 = time.perf_counter()
        with label, (spt.use_mesh(mesh) if mesh is not None else contextlib.nullcontext()):
            out = frontend(adatas[k], **call["args"])
            data = np.asarray(out.data)
        sync()
        t1 = time.perf_counter()
        h1 = routine.transfer_counts()["h2d"]
        crs = seen[n0:]
        first = crs[0][0]
        # the payload is what the engine uploads before the call's second
        # routine (if any) starts
        payload_end = crs[1][1] if len(crs) > 1 else h1
        blocks = []
        for p in first.chunk_plan:
            if p.get("source") == "upload":
                n_shard = len(p["shard_rows"][0])
                row_bytes = int(np.prod(p["shape"])) * pool[k].dtype.itemsize
                blocks += [p["chunk"] // n_shard * row_bytes
                           for _ in p["rows"] for own in owned if own]
        trials_here = sum(nv for p in first.chunk_plan for rows in p["shard_rows"]
                          for nv, own in zip(rows, owned) if own)
        rec = {"index": i, "kind": kind, "wall": t1 - t0, "t1": t1, "trials": config["trials"],
               "sources": sorted({p.get("source") for p in first.chunk_plan}),
               "h2d": payload_end - h0, "payload_blocks": blocks,
               "work": refs[kind].work(config, call["args"], int(trials_here))}
        if c0 is not None:
            c1 = pmesh.collective_counts()
            rec["collective"] = {key: c1[key] - c0[key] for key in c1}
        del seen[:]
        return data, rec

    # -- warm-up: each of the cell's call kinds once
    t_warm = time.perf_counter()
    for kind in plan.warm_kinds():
        one_call(-1, kind, 0)
    routine.reset_transfer_counts()
    t_warm = time.perf_counter() - t_warm

    prof = None
    if opts.trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
    if dist is not None:
        dist.barrier()
    sync()

    # -- the window
    rng = random.Random(opts.seed)
    keep = {kind: [] for kind in plan.warm_kinds()}
    per_kind = int(config["check_per_kind"])
    seen_kind = dict.fromkeys(keep, 0)
    records = []
    flag = torch.ones(1, dtype=torch.int32, device=dev if cuda else "cpu")
    if prof is not None:
        prof.__enter__()
    t_win = time.perf_counter()
    setup_s = t_win - opts.t_start
    i = 0
    while True:
        if rank == 0:
            flag.fill_(int(time.perf_counter() - t_win < opts.seconds or i == 0))
        if dist is not None:
            dist.broadcast(flag, 0)
        if not int(flag.item()):
            break
        kind, k = plan.kind(i), plan.dataset(i)
        data, rec = one_call(i, kind, k)
        records.append(rec)
        # a sample of each kind's results, drawn from the seed (reservoir)
        seen_kind[kind] += 1
        if len(keep[kind]) < per_kind:
            keep[kind].append((i, k, data))
        else:
            j = rng.randrange(seen_kind[kind])
            if j < per_kind:
                keep[kind][j] = (i, k, data)
        del data
        i += 1
    if prof is not None:
        prof.__exit__(None, None, None)
    routine.ComputationalRoutine.initialize = initialize
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0

    # -- the program's state freed, then the check against the references
    del adatas
    spt.clear_device_cache()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    errs = {}
    for kind, kept in keep.items():
        want = {}
        for idx, k, data in kept:
            if k not in want:
                want[k] = refs[kind].expected(pool[k], config, calls[kind]["args"], dev)
            for name, v in refs[kind].check(data, want[k], config).items():
                errs[name] = max(errs.get(name, 0.0), v)
        del want
    expect = plan.expect_source
    off = [r["index"] for r in records
           if r["sources"] != [expect] or (r["h2d"] != sum(r["payload_blocks"]) or r["h2d"] == 0
                                           if expect == "upload" else r["h2d"] != 0)]

    t_check = time.perf_counter() - t_check
    stats = {"rank": rank, "setup_s": setup_s, "t_win": t_win, "check_s": t_check,
             "setup_parts": {"library_s": library_s["s"], "data_s": t_data, "warm_s": t_warm},
             "records": records, "errs": errs, "off_path": off, "peak": peak}
    if prof is not None:
        t_trace = time.perf_counter()
        stats.update(reduce_trace(prof, records, layer, cuda))
        stats["trace_s"] = time.perf_counter() - t_trace
    stats["forbidden"] = guard.forbidden()
    if dist is not None:
        gathered = [None] * world
        dist.all_gather_object(gathered, stats)
        dist.barrier()
        dist.destroy_process_group()
        stats = {"ranks": gathered}
    else:
        stats = {"ranks": [stats]}
    return stats


class Context:
    """What a metric reader reads: ``calls`` (the harness's record of each
    call of the window), ``kernel_names`` (the metric folder's ``*.txt``
    lines), and ``trace`` (a :class:`Trace`, in the traced run) or
    ``setup_s`` and ``window_s`` (the seconds from the window's start to
    the last call's completion, in the untraced run)."""

    def __init__(self, calls, kernel_names=(), trace=None, setup_s=None, window_s=None):
        self.calls, self.kernel_names, self.trace = calls, list(kernel_names), trace
        self.setup_s, self.window_s = setup_s, window_s


def read_metric(m, ctx_kw):
    """Metric `m`'s value from its folder's reader, or None where the reader
    found nothing to read."""
    d = Path(m["dir"])
    names = sorted({line.strip() for f in sorted(d.glob("*.txt"))
                    for line in open(f) if line.strip()})
    reader = load_file(d / "reader.py", "portbench_metric_" + m["name"])
    v = reader.read(Context(kernel_names=names, **ctx_kw))
    return None if v is None else float(v)


def reduce_trace(prof, records, layer, cuda):
    """The traced window's per-layer metrics, busy and window seconds and
    breakdown, from the profiler's Chrome trace (written to a temporary
    file, read, deleted)."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        trace = Trace.load(path)
    finally:
        os.unlink(path)
    values = {}
    for m in layer:
        v = read_metric(m, {"calls": records, "trace": trace})
        if v is not None:
            values[m["name"]] = v
    window = trace.window()
    return {"layer": values, "busy_s": trace.busy_us() * 1e-6,
            "window_s": (window[1] - window[0]) * 1e-6 if window else 0.0,
            "breakdown": trace.breakdown()}


def report(stats, cell, config, e2e, layer, world, cuda):
    """Print the run's summary lines, the compared numbers and the result's
    line; returns the exit code."""
    import json

    import torch

    ranks = stats["ranks"]
    r0 = ranks[0]
    found = sorted({n for r in ranks for n in r["forbidden"]})
    if found:
        print("portbench: loaded in the run: {}".format(", ".join(found)), file=sys.stderr)
        return 1
    recs = r0["records"]
    walls = [r["wall"] for r in recs]
    span = recs[-1]["t1"] - r0["t_win"]
    sources = {}
    for r in recs:
        key = "+".join(r["sources"])
        sources[key] = sources.get(key, 0) + 1
    off = sorted({i for r in ranks for i in r["off_path"]})
    h2d = sorted({r["h2d"] for rk in ranks for r in rk["records"]})
    p95 = statistics.quantiles(walls, n=20, method="inclusive")[-1] if len(walls) > 1 else walls[0]
    tenths = [statistics.median(walls[len(walls) * k // 10:max(len(walls) * (k + 1) // 10,
                                                                 len(walls) * k // 10 + 1)])
              for k in range(10)]
    parts = max((r["setup_parts"] for r in ranks), key=lambda p: p["library_s"])
    lines = ["portbench {}: {} calls in {:.3f} s, {} trials; walls min {:.4f} median {:.4f} "
             "p95 {:.4f} max {:.4f} s; median by tenth of the calls {}".format(
                 cell["name"], len(recs), span, sum(r["trials"] for r in recs), min(walls),
                 statistics.median(walls), p95, max(walls),
                 " ".join("{:.4f}".format(t) for t in tenths)),
             "portbench {}: set-up {:.3f} s, of it the program's libraries (an nvcc build on a "
             "checkout's first run) {:.3f} s, data {:.3f} s, warm-up {:.3f} s".format(
                 cell["name"], r0["setup_s"], parts["library_s"], parts["data_s"],
                 parts["warm_s"]),
             "portbench {}: chunk sources {}; payload bytes uploaded per call and rank {}; "
             "calls off the mix's path: {}".format(cell["name"], sources, h2d, off or "none")]
    lines.append("portbench {}: the check took {:.1f} s{}; memory peak {} B".format(
        cell["name"], max(r["check_s"] for r in ranks),
        ", the trace's reduction {:.1f} s".format(max(r["trace_s"] for r in ranks))
        if "trace_s" in r0 else "", max(r["peak"] for r in ranks)))
    if world > 1:
        coll = sorted({json.dumps(r.get("collective")) for rk in ranks for r in rk["records"]})
        lines.append("portbench {}: bytes through the collectives per call and rank {}".format(
            cell["name"], coll))
    for line in lines:
        print(line)
        print(line, file=sys.stderr)

    # the compared numbers, each beside its limit
    checks = {}
    for name in sorted({n for r in ranks for n in r["errs"]}):
        checks[name] = {"value": max(r["errs"][name] for r in ranks if name in r["errs"]),
                        "limit": config["limits"][name]}
    checks["calls_off_path"] = {"value": len(off), "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and bool(recs)

    trace = "layer" in r0
    if trace:
        metrics = dict(r0["layer"])
    else:
        metrics = {}
        for m in e2e:
            v = read_metric(m, {"calls": recs, "setup_s": r0["setup_s"], "window_s": span})
            if v is not None:
                metrics[m["name"]] = v
    units = {m["name"]: m["unit"] for m in e2e + layer}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu", "count": world,
              "memory_peak_bytes": max(r["peak"] for r in ranks)}
    if trace:
        device["busy_s"] = sum(r["busy_s"] for r in ranks) / len(ranks)
        device["window_s"] = sum(r["window_s"] for r in ranks) / len(ranks)
    result = {"correct": correct, "attempted": len(recs), "failed": 0,
              "metrics": {k: {"value": v, "unit": units[k]} for k, v in metrics.items()},
              "device": device, "setup_parts": parts}
    if trace:
        result["breakdown"] = r0["breakdown"]
    result["checks"] = checks
    for name, c in checks.items():
        print("check {}: {} (limit {})".format(name, c["value"], c["limit"]), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
