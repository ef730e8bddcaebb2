"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of RecFlash.

``python3 recbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on one CUDA card and
prints one JSON line. Everything that belongs to one configuration, one
traffic mix or one metric is a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<traffic>.json`` and
``metrics/<metric>.py``. The yardstick (traffic generation, table and
weight synthesis, the plain reference, roofline and FLOP arithmetic, trace
reduction) lives here too; of the program the benchmark takes only
``repro_torch``'s set-up path, its forward and its kernel names.
"""
