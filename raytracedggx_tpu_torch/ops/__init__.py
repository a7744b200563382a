"""Kernels and their host-side structures (K1 in fused.py, K2/K3 in
spatial_cuda.py; the CUDA sources are in ../csrc)."""
