"""Kernel launches a training step: every CUDA kernel of the traced steps,
by the profiler, over their number (layer: dispatch)."""

from perfbench.yardstick.readers import launches as read  # noqa: F401
