"""The benchmark of the PyTorch/CUDA port of copy detection (``repro_torch``).

``python3 cdbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints its
result as one JSON line. Everything a cell is made of is found by name:
``configs/<config>.json``, ``traffic/<traffic>.json`` (which names a driver
in ``drivers/``), ``limits/<cell>.json`` and ``metrics/<metric>.py``.
"""
