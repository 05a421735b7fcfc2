"""The benchmark of qmps_torch, the PyTorch and CUDA port: one command runs
one cell once (``python3 -m port_bench.run``, see ``run.py``)."""
