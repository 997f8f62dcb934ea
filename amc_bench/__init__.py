"""The benchmark of ``modulationdetectioncnn_torch`` on one NVIDIA H100.

``python3 -m amc_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once (``run.py``). Nothing here imports
JAX or the JAX package, and ``reference/`` imports nothing of the program.
"""
