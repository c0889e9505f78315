"""Device kernels a step in the profiled sub-window (host dispatch is what
bounds a step whose device idles)."""
from portbench.metrics.lib.readers import launches_per_step as read  # noqa: F401
