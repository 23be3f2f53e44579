"""The serving benchmark of ``repro_torch``, the PyTorch/CUDA port.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` on the card it starts on and
prints one JSON line.  Everything that belongs to one configuration, one
traffic mix, one cell, one metric or one model family is a file of its
own, found by name: ``bench/configs/<config>.json``,
``bench/traffic/<mix>.json``, ``bench/workloads/<cell>.json``,
``bench/metrics/<metric>.py`` and ``bench/families/<family>.py`` (the
configuration's ``family``, with its reference under
``bench/reference/``).  The yardstick (traffic generation, the metric
arithmetic, the peaks, the plain reference and the comparison that
decides ``correct``) lives here; from the program the benchmark takes
only the engine it serves through and the engine's counters.
"""
