"""The benchmark of voxe_tpu_torch, the PyTorch and CUDA port: `python -m
portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`.
Cells, configurations, entries and per-layer metrics are files found by the
names in BENCHMARK.json; see portbench/run.py."""
