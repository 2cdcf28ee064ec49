"""Kernel launches a forecast request: every CUDA kernel of the traced
requests, by the profiler, over their number (layer: dispatch)."""

from perfbench.yardstick.readers import launches as read  # noqa: F401
