"""Device time a forecast request keeps the card busy, in ms: the union
of kernel, copy and memset intervals of the traced requests over their
number (layer: device)."""

from perfbench.yardstick.readers import device_ms as read  # noqa: F401
