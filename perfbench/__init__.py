"""Benchmark of the PyTorch and CUDA port of GF-DiT serving on one NVIDIA
H100: ``python3 perfbench/run.py --workload W --seed N --seconds S
--trace 0|1``, with cells, metrics and bounds in ``BENCHMARK.json``."""
