"""portbench: the benchmark of litemkd_torch, the PyTorch and CUDA port, on
NVIDIA H100 cards. ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once."""
