"""The benchmark of the PyTorch and CUDA port (``mnasnet_tpu_torch``): one
cell of ``BENCHMARK.json`` a run, ``python3 -m benchmark.run``."""
