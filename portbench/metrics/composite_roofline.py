"""The compositing kernel (csrc/composite_fwd.cu) against its least time,
its bytes at the one [N, S] it launched over the HBM bandwidth, from its
device time in the trace; the program's launch counter must agree."""
from portbench.metrics.lib.opcount import composite_bound_s
from portbench.metrics.lib.readers import roofline

COUNTERS = {
    "composite_launches": ("voxe_tpu_torch.ops.composite", "LAUNCHES", "delta"),
    "composite_shapes": ("voxe_tpu_torch.ops.composite", "LAUNCHED_SHAPES", "copy"),
}


def read(trace):
    shapes = trace.counters["composite_shapes"]
    if len(shapes) != 1:
        return None
    (n, s), = shapes
    return roofline(trace, "composite_fwd_kernel", trace.counters["composite_launches"], composite_bound_s(n, s))
