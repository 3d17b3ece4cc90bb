"""Iter-Fisher kernels: CUDA on the card, plain PyTorch on the CPU."""
