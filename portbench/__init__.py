"""The benchmark of the PyTorch and CUDA port (``repro_torch``): AD-GDA
training rounds at full published width on one card.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; see ``README.md``.
Nothing here imports ``jax``, the JAX package or ``benchmarks/``.
"""
