"""Attention and RWKV-6 scan kernels: hand-written CUDA for Hopper (``csrc/``), their
ctypes wrappers, the plain PyTorch versions (``ref.py``) and the dispatch
by device (``ops.py``)."""
