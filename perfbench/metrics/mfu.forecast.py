"""Model FLOPs utilisation of forecasting, in %: the forward FLOPs a
forecast needs (every layer at every window position, the forecast head
at the last position; yardstick/flops.py) of the window's requests over
its seconds and the bf16 peak, over the untraced window (layer: model step)."""

from perfbench.yardstick.readers import mfu as read  # noqa: F401
