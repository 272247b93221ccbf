"""Attention ops: plain PyTorch oracles and the hand-written CUDA kernels."""
