"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one H100.

``python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints its
result as the last line of standard output.
"""
