"""The one traffic generator: a mix is a data file, ``traffic/<name>.json``.

Keys of a mix:

- ``calls``: the configuration's call kinds to cycle through, in order;
  ``"default"`` stands for the configuration's ``default_call``.
- ``datasets``: how many datasets the process analyses; call i analyses
  dataset i modulo their number.
- ``clear_store``: empty the device trial store (``clear_device_cache()``,
  on every rank) before each call, outside the call's wall.
- ``expect_source``: where every timed call's chunks must come from
  (``"upload"`` or ``"trial store"``); a call that differs is off its path
  and counted.

The seed draws the data, never the sequence of calls or sizes: every seed
gives the same work.
"""


class Plan:
    """The calls of one run: ``kind(i)`` and ``dataset(i)`` of call i."""

    def __init__(self, config, mix):
        self.kinds = [config["default_call"] if k == "default" else k for k in mix["calls"]]
        for k in self.kinds:
            if k not in config["calls"]:
                raise ValueError("the mix calls {!r}, which configuration {} lacks".format(
                    k, config["name"]))
        self.n_datasets = int(mix["datasets"])
        self.clear_store = bool(mix["clear_store"])
        self.expect_source = mix["expect_source"]
        if self.expect_source not in ("upload", "trial store"):
            raise ValueError("expect_source {!r}".format(self.expect_source))

    def kind(self, i):
        return self.kinds[i % len(self.kinds)]

    def dataset(self, i):
        return i % self.n_datasets

    def warm_kinds(self):
        """Each call kind once, in the mix's order."""
        return list(dict.fromkeys(self.kinds))
