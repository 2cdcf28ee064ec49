"""The median time a forecast request takes once it starts, in ms (host
clock, the untraced window): the steady part of ``forecast_ms_p95``,
without the wait behind an earlier request (layer: model step)."""

from perfbench.yardstick.readers import service_ms_median as read  # noqa: F401
