"""The benchmark of the PyTorch and CUDA port (``compactfusion_tpu_torch``):
``python3 cfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
