"""The host's ms a step inside its syncs in the profiled steps (the
program's `SYNC_NS`): the time it waited for the card instead of
dispatching the next operators."""
from portbench.metrics.lib.syncs import sync_wait_ms as read  # noqa: F401

COUNTERS = {"sync_wait_ns": ("portbench.metrics.lib.syncs", "SYNC_NS", "delta")}
