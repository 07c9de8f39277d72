"""Each metric reader on a small synthetic trace gives the value counted
by hand."""

from pathlib import Path

import pytest

from portbench.core import cell, manifest, roofline
from portbench.core.trace import Trace

METRICS = manifest.BENCH_DIR / "metrics"


def x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1,
            "args": args}


def events():
    """Two calls of 100 ms at 0 and 200 ms (microseconds below). Call 0: a
    16 B taper upload launched at 5 ms, the 1000 B payload upload launched
    at 30 ms and taking 50 ms, the CSD kernel (2 ms), a collective (1 ms).
    Call 1: the PPC kernel (4 ms) and nothing else."""
    return [
        x("user_annotation", "portbench.call.0", 0.0, 100000.0),
        x("cpu_op", "aten::copy_", 29000.0, 52000.0),
        x("cuda_runtime", "cudaMemcpyAsync", 5000.0, 5.0, correlation=2),
        x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 5010.0, 10.0, tid=7, correlation=2,
          bytes=16),
        x("cuda_runtime", "cudaMemcpyAsync", 30000.0, 50000.0, correlation=1),
        x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 30010.0, 50000.0, tid=7,
          correlation=1, bytes=1000),
        x("cuda_runtime", "cudaLaunchKernel", 85000.0, 5.0, correlation=3),
        x("kernel", "void csd_accumulate_kernel<TiledRows>(...)", 85010.0, 2000.0, tid=7,
          correlation=3),
        x("cuda_runtime", "cudaLaunchKernel", 90000.0, 5.0, correlation=4),
        x("kernel", "ncclDevKernel_Broadcast_RING_LL(...)", 90010.0, 1000.0, tid=7,
          correlation=4),
        x("user_annotation", "portbench.call.1", 200000.0, 100000.0),
        x("cuda_runtime", "cudaLaunchKernel", 210000.0, 5.0, correlation=5),
        x("kernel", "void ppc_accumulate_kernel<3>(...)", 210010.0, 4000.0, tid=7,
          correlation=5),
    ]


def calls():
    return [{"index": 0, "kind": "coh", "trials": 1000, "payload_blocks": [1000], "h2d": 1000,
             "work": {"csd": {"F": 501, "rows": 3000, "C": 128}}},
            {"index": 1, "kind": "ppc", "trials": 1000, "payload_blocks": [], "h2d": 0,
             "work": {"ppc": {"F": 501, "n": 1000, "K": 3, "C": 128}}}]


def read(name, trace=None, recs=None, **kw):
    kw = kw or {"trace": trace or Trace(events())}
    return cell.read_metric({"name": name, "dir": METRICS / name},
                            dict(kw, calls=recs or calls()))


def test_host_prep():
    assert read("engine.host_prep_ms") == pytest.approx(30.0)


def test_h2d():
    assert read("engine.h2d_ms") == pytest.approx(50.0)


def test_h2d_bytes_mismatch_left_out():
    recs = calls()
    recs[0]["h2d"] = 999
    assert read("engine.h2d_ms", recs=recs) is None


def test_csd_roofline():
    want = 100 * roofline.csd_bound(501, 3000, 128)[0] / 2.0
    assert read("kernel.csd_roofline") == pytest.approx(want)


def test_ppc_roofline():
    want = 100 * roofline.ppc_bound(501, 1000, 3, 128)[0] / 4.0
    assert read("kernel.ppc_roofline") == pytest.approx(want)


def test_end_to_end_readers():
    assert read("trials_per_s", setup_s=12.5, window_s=4.0) == pytest.approx(500.0)
    assert read("setup_s", setup_s=12.5, window_s=4.0) == pytest.approx(12.5)


def test_nccl():
    assert read("mesh.nccl_ms") == pytest.approx(1.0)


def test_idle_share():
    busy = 10.0 + 50000.0 + 2000.0 + 1000.0 + 4000.0
    assert read("device.idle_share") == pytest.approx(100 * (1 - busy / 300000.0))


def test_nothing_to_read_gives_none():
    empty = Trace([x("user_annotation", "portbench.call.0", 0.0, 10.0)])
    for name in ("engine.host_prep_ms", "engine.h2d_ms", "kernel.csd_roofline",
                 "kernel.ppc_roofline", "mesh.nccl_ms", "device.idle_share"):
        assert read(name, trace=empty) is None, name


def test_breakdown():
    b = Trace(events()).breakdown()
    assert b["device_ops"][0] == ["Memcpy HtoD (Pageable -> Device)", pytest.approx(0.05001)]
    names = dict((k, v) for k, v in b["idle_gaps"])
    # idle from the collective's end (91.01 ms) to the PPC kernel (210.01 ms),
    # with its middle between the calls; the rest of the idle time lies in
    # the calls outside any torch op: 5.01 + 24.99 + 5.0 + 3.0 + 85.99 ms
    assert names["between calls"] == pytest.approx(0.119)
    assert names["portbench.call"] == pytest.approx(0.12399)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_every_metric_has_a_reader():
    bench = manifest.load()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (METRICS / m["name"] / "reader.py").is_file(), m["name"]
    assert Path(METRICS / "kernel.csd_roofline" / "kernels.txt").read_text().strip()
