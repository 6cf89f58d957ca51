"""The benchmark of the PyTorch/CUDA port (``slam_eslam_tpu_torch``).

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the CUDA device and
prints one JSON line last.  Configurations (``configs/``), traffic mixes
(``traffic/``) and per-layer metric readers (``metrics/``) are found by
the names ``BENCHMARK.json`` gives them.
"""
