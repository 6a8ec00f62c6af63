"""Alignment DP: smoothed-max operators, the stream layout, the CUDA
kernels and their plain PyTorch versions."""
