"""The program's own spans in a :class:`~portbench.core.trace.Trace`: the
``spt.*`` ``record_function`` annotations that ``syncopy_tpu_torch`` opens
at its layer boundaries (a frontend call ``spt.<frontend>``, the engine's
stages ``spt.engine.*``, the mesh's transfers ``spt.mesh.*``) while a
profiler runs. A program without them yields no span, and every reader
built on this module then finds nothing to read. Times are microseconds of
the trace's clock."""

import bisect

PREFIX = "spt."
#: the spans below a frontend: a frontend's self time leaves them out
INNER = ("spt.engine.", "spt.mesh.")


def spans(trace):
    """Every ``spt.*`` span on the calls' thread, as (start, end, name),
    sorted by start."""
    return [(s, e, n) for s, e, n, _ in trace.host if n.startswith(PREFIX)]


def by_call(trace):
    """``{call index: [(start, end, name), ...]}``: the spans that lie
    within each harness call's span, for the calls that hold any."""
    sp = spans(trace)
    starts = [s for s, _, _ in sp]
    out = {}
    for i, (c0, c1, _) in trace.calls.items():
        inside = [x for x in sp[bisect.bisect_left(starts, c0):bisect.bisect_right(starts, c1)]
                  if x[1] <= c1]
        if inside:
            out[i] = inside
    return out


def union(intervals):
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def covered(intervals, within=None):
    """The length of the union of `intervals`, clipped to `within`."""
    if within is not None:
        intervals = [(max(s, within[0]), min(e, within[1])) for s, e in intervals]
    return sum(e - s for s, e in union((s, e) for s, e in intervals if e > s))


def mean_ms(values_us):
    """The mean of per-call microseconds, in ms; None where no call held
    the span."""
    return sum(values_us) / len(values_us) / 1e3 if values_us else None


def summed_ms(trace, names):
    """Per call, the time under each span of `names`, counted once where
    spans of one name nest, summed over the names; the mean over the calls
    that hold one, in ms."""
    vals = []
    for sp in by_call(trace).values():
        got = [[(s, e) for s, e, n in sp if n == name] for name in names]
        if any(got):
            vals.append(sum(covered(iv) for iv in got))
    return mean_ms(vals)


def frontend_self_ms(trace):
    """Per call, the self time of its outermost frontend spans
    (``spt.<frontend>``): their duration less what the engine's and the
    mesh's spans inside them cover; the mean over the calls that hold one,
    in ms."""
    vals = []
    for sp in by_call(trace).values():
        outer, end = [], None
        # by start, the longer first where two start together
        for s, e in sorted(((s, e) for s, e, n in sp if not n.startswith(INNER)),
                           key=lambda x: (x[0], -x[1])):
            if end is None or e > end:
                outer.append((s, e))
                end = e
        if outer:
            inner = [(s, e) for s, e, n in sp if n.startswith(INNER)]
            vals.append(sum((e - s) - covered(inner, (s, e)) for s, e in outer))
    return mean_ms(vals)


def unspanned_idle_share(trace):
    """100 x the device's idle time of the window (``trace.gaps()``) in gaps
    at whose middle no ``spt.*`` span is open, at any depth, over the
    window; None without spans."""
    sp = spans(trace)
    window = trace.window()
    if not sp or window is None or window[1] <= window[0]:
        return None
    merged = union((s, e) for s, e, _ in sp)
    starts = [s for s, _ in merged]
    idle = 0.0
    for s, e in trace.gaps():
        mid = (s + e) / 2
        j = bisect.bisect_right(starts, mid) - 1
        if j < 0 or merged[j][1] < mid:
            idle += e - s
    return 100.0 * idle / (window[1] - window[0])
