"""Hopper kernels of the port (CUDA C++ in ``csrc/``) with their plain
PyTorch versions; :mod:`repro_torch.kernels.ops` dispatches by device."""
