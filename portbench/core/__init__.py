"""The general parts of the harness: manifest, traffic generator, the run of
one rank, the multi-rank launcher, the trace reduction and the yardstick's
arithmetic."""
