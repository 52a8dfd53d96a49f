"""Kernels of the port: each a hand-written CUDA kernel beside its plain
PyTorch version (``ops/rnn.py``, ``ops/gather.py``; built by
``ops/_build.py``)."""
