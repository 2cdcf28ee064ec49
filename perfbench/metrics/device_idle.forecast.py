"""The device's idle share in forecasting, in %: 1 - the union of kernel,
copy and memset intervals over the traced requests' length (layer: device)."""

from perfbench.yardstick.readers import device_idle as read  # noqa: F401
