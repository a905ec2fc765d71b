"""The benchmark of ``pysparselp_tpu_torch`` on one NVIDIA GPU.

``python3 lp_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line.  Configurations (``configs/``), traffic mixes
(``traffic/``), the limits of each cell's output check (``limits/``) and
the per-layer metric readers (``metrics/``) are files found by the names
``BENCHMARK.json`` gives; ``lib/`` holds the general harness and
``reference/`` the plain references that decide ``correct``.
"""
