"""The SDXL edit step's model FLOPs (`opcount_xl`) over the untraced
window's time a step times the bf16 dense peak."""
from portbench.metrics.lib.opcount_xl import edit_step_flops
from portbench.metrics.lib.readers import step_mfu


def read(trace):
    return step_mfu(trace, edit_step_flops(trace.config))
