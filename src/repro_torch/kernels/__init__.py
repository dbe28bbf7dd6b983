"""The port's kernels: CUDA C++ under ``csrc/`` with thin PyTorch
wrappers, and their plain PyTorch versions in ``ref.py``."""
