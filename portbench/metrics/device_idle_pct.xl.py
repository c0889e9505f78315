"""The share of the step in which no device operation runs: the traced
steps' device time a step (union of the operations' intervals) against the
untraced window's time a step."""
from portbench.metrics.lib.readers import device_idle_pct as read  # noqa: F401
