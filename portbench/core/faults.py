"""Faults planted under the timed path, for the harness's own tests: each
must turn ``correct`` false. Never installed by a benchmark run; only the
``--fault`` option of run.py (which the tests pass) installs one.

- ``stale``: every call returns the result of the call before it.
- ``half_batch``: the program sees only the first half of the trials (the
  mean taken over the rest).
- ``no_exchange``: across ranks, each peer's partial arrives as zeros (the
  exchange between the chips left out).
- ``altered``: one value of every result is changed where it is produced.
- ``load_jax``: a module named ``jax`` is loaded (the import guard must
  refuse the run).
"""

import numpy as np

FAULTS = ("stale", "half_batch", "no_exchange", "altered", "load_jax")


def install(name, spt, config, pool, trl):
    """Plant fault `name` under every frontend that the configuration's
    calls name (or, for ``no_exchange``, under the engine's exchange)."""
    if name not in FAULTS:
        raise ValueError("no fault {!r}".format(name))
    if name == "load_jax":
        import sys
        import types

        sys.modules["jax"] = types.ModuleType("jax")
        return
    if name == "no_exchange":
        from syncopy_tpu_torch.engine import routine

        share = routine.share_from

        def no_exchange(tensor, src, device, info=None):
            got, info = share(tensor, src, device, info)
            if tensor is None:
                got = got.new_zeros(got.shape)
            return got, info

        routine.share_from = no_exchange
        return
    for frontend in sorted({c["frontend"] for c in config["calls"].values()}):
        setattr(spt, frontend, _faulty(name, getattr(spt, frontend), spt, config, pool, trl))


def _faulty(name, real, spt, config, pool, trl):
    if name == "stale":
        last = []

        def call(data, **kw):
            out = real(data, **kw)
            last.append(out)
            return last[-2] if len(last) > 1 else out

    elif name == "half_batch":
        halves = {}

        def call(data, **kw):
            key = id(data)
            if key not in halves:
                k = next(j for j, p in enumerate(pool) if np.shares_memory(p, data.data))
                n = config["trials"] // 2
                halves[key] = spt.from_arrays(pool[k][: n * config["samples"]], trl[:n],
                                              config["samplerate"])
            return real(halves[key], **kw)

    else:

        def call(data, **kw):
            out = real(data, **kw)
            arr = np.array(out.data)
            arr.flat[arr.size // 3] += 1e-3
            out.data = arr
            return out

    return call
