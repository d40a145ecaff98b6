"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

``run.py`` is the command.  Everything that belongs to one configuration,
traffic mix, cell or per-layer metric is a file of its own, found by the
name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the model's sizes as run, its source and cuts;
* ``traffic/<mix>.json``: the mix's parameters; its ``kind`` names the
  driver (``drivers/<kind>.py``) that reads them, drives the program and
  works out the kind's end-to-end metrics;
* ``limits/<cell>.json``: the limits of the numbers that decide
  ``correct`` in that cell;
* ``metrics/<metric>.py``: the reader of one per-layer metric, with the
  program's counters it reads.

The yardstick lives here and not in the program: traffic generation, the
timing and the reduction of the profiler's trace (``timing``), the counts
of operations and bytes (``counts``), the weights and caches drawn from
the seed (``weights``) and the plain fp32 reference (``reference``).
"""
