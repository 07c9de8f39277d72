"""portbench: the benchmark of the PyTorch and CUDA port, syncopy_tpu_torch.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) on the CUDA cards of this machine:

    python3 portbench/run.py --workload coh128.store --seed 7 --seconds 51 --trace 0

Everything that belongs to one configuration, traffic mix or
metric is a file of its own, found by the name that ``BENCHMARK.json``
gives it: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>/reader.py`` (with its kernel-name ``*.txt`` files),
``datagen/<generator>.py`` and ``reference/<reference>.py``.
"""
