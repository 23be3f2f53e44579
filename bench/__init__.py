"""The serving benchmark of ``repro_torch``, the PyTorch/CUDA port.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` on the card it starts on and
prints one JSON line.  Everything that belongs to one configuration, one
traffic mix, one cell or one metric is a file of its own, found by name:
``bench/configs/<config>.json``, ``bench/traffic/<mix>.json``,
``bench/workloads/<cell>.json`` and ``bench/metrics/<metric>.py``.  The
yardstick (traffic generation, the metric arithmetic, the peaks, the plain
reference and the comparison that decides ``correct``) lives here; from
the program the benchmark takes only the engine it serves through and the
engine's counters.
"""
