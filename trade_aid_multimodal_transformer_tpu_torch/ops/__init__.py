"""Layers, attention cores and the hand-written CUDA kernels."""
