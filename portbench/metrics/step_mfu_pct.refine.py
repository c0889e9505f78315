"""The step's model FLOPs over the untraced window's time a step times the
bf16 dense peak."""
from portbench.metrics.lib.opcount import refine_step_flops
from portbench.metrics.lib.readers import step_mfu


def read(trace):
    return step_mfu(trace, refine_step_flops(trace.config))
