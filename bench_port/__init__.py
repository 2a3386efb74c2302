"""The benchmark of the PyTorch and CUDA port (``lightkrylov_tpu_torch``):
``python bench_port/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``.  See ``bench_port/README.md``."""
