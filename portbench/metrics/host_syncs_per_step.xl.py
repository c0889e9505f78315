"""Host syncs a step in the profiled steps: the program's reads of device
values and blocking copies of host values, each made through its tracing
module (`SYNCS`). Each one drains the card's queue before the host goes on."""
from portbench.metrics.lib.syncs import syncs_per_step as read  # noqa: F401

COUNTERS = {"host_syncs": ("portbench.metrics.lib.syncs", "SYNCS", "delta")}
