"""sdpbench: the benchmark of hdsdp_tpu_torch, the PyTorch and CUDA port.

One command runs one cell of ``BENCHMARK.json`` once:

    python3 -m sdpbench.run --workload NAME --seed N --seconds S --trace 0|1

See ``sdpbench/README.md``.  Importing this package imports neither the
port nor torch.
"""
