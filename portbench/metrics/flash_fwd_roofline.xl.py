"""The SDXL UNet's flash self-attention forward (csrc/flash_attn_fwd.cu)
against its least time at the step's shape (the first level with
attention: [2, 4096, 10, 64]), from its device time in the trace; the
program's launch counter must agree with the kernels found."""
from portbench.metrics.lib.opcount import flash_fwd_bound_s
from portbench.metrics.lib.opcount_xl import flash_shape
from portbench.metrics.lib.readers import roofline

COUNTERS = {"flash_fwd_launches": ("voxe_tpu_torch.ops.flash_attention", "LAUNCHES", "delta")}


def read(trace):
    return roofline(trace, "flash_fwd_kernel", trace.counters["flash_fwd_launches"],
                    flash_fwd_bound_s(flash_shape(trace.config["sd"])))
