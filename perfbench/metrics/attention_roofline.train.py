"""The attention kernels' share of their roofline in training, in %: the
least time of the traced steps' attention work, forward and backward, from
the model's shapes (yardstick/flops.py), over the device time of the
program's attention kernels in them (layer: kernels)."""

from perfbench.yardstick.readers import attention_roofline as read  # noqa: F401
