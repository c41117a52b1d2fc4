"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

It mirrors ``repro``'s layout module for module, imports nothing of it,
and is held against it by ``tests/test_torch_*.py``.
"""
