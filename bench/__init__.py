"""The benchmark of the PyTorch and CUDA port (``repro_torch``): an on-card
FB+-tree key directory served in batches under YCSB traffic.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json``. Everything a cell needs is
found by name: its configuration in ``configs/<name>.json``, its traffic in
``traffic/<name>.json``, the key set a configuration names in
``keysets/<name>.py``, the request distribution a traffic names in
``dists/<name>.py`` and each per-layer metric in ``metrics/<name>.py``.
Nothing here imports JAX, the JAX package, ``benchmarks`` or
``chip_smoke``; ``reference/`` imports nothing of ``repro_torch`` either.
"""
