"""The benchmark harness of the PyTorch and CUDA port (``bench_h100/run.py``)."""
