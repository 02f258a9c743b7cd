"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints one
JSON line.  Everything that belongs to one configuration, traffic mix or
per-layer metric is a file of its own, found by the name
``BENCHMARK.json`` gives: ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``metrics/<metric>.py``.  ``ref/`` holds the
plain reference the runs are checked against.
"""
