"""cellbench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 -m cellbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card(s) of
this machine and prints one JSON result line.  Cells, configurations,
traffic mixes, limits and per-layer metrics are found by name in files
of their own (``configs/``, ``traffic/``, ``limits/``, ``metrics/``).
"""
