"""Tensor ops of the PyTorch port: frontend, attention and the CUDA kernels."""
