"""The benchmark of the PyTorch/CUDA port ``repro_torch``.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` replays one cell of ``BENCHMARK.json`` on the card and
prints one JSON line.  Every configuration, cell and metric is a file of
its own under this folder, found by the name ``BENCHMARK.json`` gives it
(``spec.py``).  Nothing here imports JAX or the JAX package ``repro``.
"""
