"""The reduction of a ``torch.profiler`` Chrome trace to what the metric
readers and the result's ``device`` and ``breakdown`` need.

The harness marks each timed call with ``record_function("portbench.call.<i>")``;
device work belongs to the call whose span holds its launch (the CUDA
runtime call that the device record's ``correlation`` names). Times are in
microseconds of the trace's clock."""

import json
import re

CALL = re.compile(r"^portbench\.call\.(\d+)$")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


class Trace:
    def __init__(self, events):
        self.device, self.host, self.calls, self.launch = [], [], {}, {}
        self._by_call = None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, dur = e.get("cat", ""), float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                self.device.append({"name": e.get("name", ""), "cat": cat, "start": ts,
                                    "end": ts + dur, "bytes": args.get("bytes"),
                                    "corr": args.get("correlation")})
            elif cat in ("cuda_runtime", "cuda_driver"):
                if args.get("correlation") is not None:
                    self.launch[args["correlation"]] = (ts, e.get("name", ""))
            elif cat in HOST_CATS:
                m = CALL.match(e.get("name", ""))
                if m:
                    self.calls[int(m.group(1))] = (ts, ts + dur, e.get("tid"))
                self.host.append((ts, ts + dur, e.get("name", ""), e.get("tid")))
        self.device.sort(key=lambda d: d["start"])
        tids = {c[2] for c in self.calls.values()}
        self.host = sorted((h for h in self.host if h[3] in tids), key=lambda h: h[0])

    @classmethod
    def load(cls, path):
        with open(path) as f:
            return cls(json.load(f).get("traceEvents", []))

    def window(self):
        """(start, end) of the traced window: the first call's start to the
        last call's end; None without calls."""
        if not self.calls:
            return None
        return (min(c[0] for c in self.calls.values()), max(c[1] for c in self.calls.values()))

    def launched_at(self, d):
        """When the host launched device record `d` (its own start where no
        launch is linked)."""
        hit = self.launch.get(d["corr"])
        return d["start"] if hit is None else hit[0]

    def of_call(self, i):
        """Device records launched inside call i's span."""
        if self._by_call is None:
            import bisect

            order = sorted(self.calls.items(), key=lambda kv: kv[1][0])
            starts = [c[1][0] for c in order]
            self._by_call = {k: [] for k in self.calls}
            for d in self.device:
                t = self.launched_at(d)
                j = bisect.bisect_right(starts, t) - 1
                if j >= 0 and t <= order[j][1][1]:
                    self._by_call[order[j][0]].append(d)
        return self._by_call.get(i, [])

    def busy_intervals(self, window=None):
        """The union of device records' intervals, clipped to `window`
        (default the traced window), as a sorted list of (start, end)."""
        window = window or self.window()
        if window is None:
            return []
        merged = []
        for d in self.device:
            s, e = max(d["start"], window[0]), min(d["end"], window[1])
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [tuple(m) for m in merged]

    def busy_us(self):
        return sum(e - s for s, e in self.busy_intervals())

    def gaps(self):
        """Idle intervals of the device inside the traced window."""
        window = self.window()
        if window is None:
            return []
        out, t = [], window[0]
        for s, e in self.busy_intervals(window):
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if window[1] > t:
            out.append((t, window[1]))
        return out

    def host_ops_at(self, times):
        """For each of the sorted `times`, the name of the innermost host op
        of the calls' thread open then: a call's own span reads
        ``portbench.call`` (Python work inside the program, outside any
        torch op); outside every call, ``between calls``. Ops on one thread
        nest, so one sweep with a stack finds them all."""
        out, stack, k = [], [], 0
        for t in times:
            while k < len(self.host) and self.host[k][0] <= t:
                h = self.host[k]
                while stack and stack[-1][1] < h[0]:
                    stack.pop()
                stack.append(h)
                k += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            if not stack:
                out.append("between calls")
            else:
                name = stack[-1][2]
                out.append("portbench.call" if CALL.match(name) else name)
        return out

    def breakdown(self, top=10):
        """``{"device_ops": [[name, s], ...], "idle_gaps": [[name, s], ...]}``:
        device time by operation name, and idle time by the host op open
        across each gap (at its middle), each the `top` largest."""
        by_op = {}
        for d in self.device:
            by_op[d["name"]] = by_op.get(d["name"], 0.0) + (d["end"] - d["start"]) * 1e-6
        by_host = {}
        gaps = self.gaps()
        for (s, e), name in zip(gaps, self.host_ops_at([(s + e) / 2 for s, e in gaps])):
            by_host[name] = by_host.get(name, 0.0) + (e - s) * 1e-6
        rank = lambda d: [[k[:200], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}


def is_htod(d):
    return d["cat"] == "gpu_memcpy" and "HtoD" in d["name"]


def payload_copies(trace, call):
    """The host-to-device copies of `call` whose sizes are those of its
    payload blocks (the harness takes them from the engine's chunk plan)."""
    blocks = set(call["payload_blocks"])
    return [d for d in trace.of_call(call["index"]) if is_htod(d) and d["bytes"] in blocks]


def kernel_share(ctx, work, bound_of):
    """100 x the summed ``bound_of(shapes)`` ms of the calls whose ``work``
    holds `work` over the device time of the kernels ``ctx.kernel_names``
    lists in them; None where no such kernel ran."""
    bound_ms = kernel_ms = 0.0
    for c in ctx.calls:
        if work not in c["work"]:
            continue
        ks = [d for d in ctx.trace.of_call(c["index"])
              if d["cat"] == "kernel" and matches(d["name"], ctx.kernel_names)]
        if ks:
            kernel_ms += sum(d["end"] - d["start"] for d in ks) / 1e3
            bound_ms += bound_of(c["work"][work])
    return 100.0 * bound_ms / kernel_ms if kernel_ms > 0 else None


def matches(name, kernel_names):
    """Whether device op `name` is one of the kernels listed (a listed name
    is a substring of the op's name)."""
    return any(k in name for k in kernel_names)
