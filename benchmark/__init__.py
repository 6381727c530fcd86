"""The benchmark of the PyTorch and CUDA port (``densepose_tpu_torch``).

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once; README.md in this folder
says what a cell, a configuration, a traffic mix and a metric reader are.
"""
