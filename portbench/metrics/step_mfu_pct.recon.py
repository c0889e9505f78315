"""The recon step's model FLOPs (the shear-warp resample and its input
gradient) over the untraced window's time a step times the bf16 dense
peak: the whole step's share that bounds the compositing kernel's gain."""
from portbench.metrics.lib.opcount import recon_step_flops
from portbench.metrics.lib.readers import step_mfu


def read(trace):
    return step_mfu(trace, recon_step_flops(trace.config))
