"""mesh.nccl_ms: per call, the device time of the collective kernels that
this folder's ``*.txt`` files list, on the rank that reports (its waits for
its peers included). Mean over the calls that ran one, in ms; each call's
bytes through the collectives are on the harness's call lines."""

from portbench.core.trace import matches


def read(ctx):
    vals = []
    for c in ctx.calls:
        ks = [d for d in ctx.trace.of_call(c["index"])
              if d["cat"] == "kernel" and matches(d["name"], ctx.kernel_names)]
        if ks:
            vals.append(sum(d["end"] - d["start"] for d in ks) / 1e3)
    return sum(vals) / len(vals) if vals else None
