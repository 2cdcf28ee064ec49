"""Model FLOPs utilisation of training, in %: the model FLOPs of the
window's steps (yardstick/flops.py, recomputation not counted) over the
window's seconds, the chips and the bf16 peak. Taken over the untraced
window, so the profiler's overhead does not lower it (layer: model step)."""

from perfbench.yardstick.readers import mfu as read  # noqa: F401
