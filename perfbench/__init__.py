"""The benchmark of ``multivae_tpu_torch`` on NVIDIA cards.

``python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``. Everything that
belongs to one configuration, traffic mix or per-layer metric is a file of
its own, found by its name: ``configs/<config>.json``,
``traffic/<traffic>.py``, ``metrics/<metric>.py``. The plain reference that
decides ``correct`` is ``reference/``; it imports nothing of the program.
"""
