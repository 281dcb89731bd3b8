"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one command
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.

    python3 cellbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Nothing here imports JAX or the JAX package; ``reference/`` imports
nothing of the port either.
"""
