"""The benchmark of the PyTorch/CUDA port (``syntalker_tpu_torch``) on NVIDIA
H100s: ``python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once."""
