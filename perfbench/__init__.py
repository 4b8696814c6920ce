"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA
H100: ``python3 perfbench/run.py --workload NAME --seed N --seconds S
--trace 0|1`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
result line. Configurations, traffic mixes and metrics are files found by
name (see ``harness.py``)."""
