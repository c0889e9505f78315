"""The compositing tail's backward kernel (csrc/composite_bwd.cu) against
its least time: its compulsory bytes at the one shape it launched over the
HBM bandwidth, from its mean device time in the trace; the program's launch
counter must agree. A program without the kernel (no `LAUNCHES_BWD` in
`voxe_tpu_torch.ops.composite`) asks for no counter and reads None."""
import importlib

from portbench.metrics.lib.opcount import PEAK_HBM_BYTES_PER_S
from portbench.metrics.lib.readers import roofline

_MODULE = "voxe_tpu_torch.ops.composite"
COUNTERS = ({"composite_bwd_launches": (_MODULE, "LAUNCHES_BWD", "delta"),
             "composite_bwd_shapes": (_MODULE, "LAUNCHED_BWD_SHAPES", "copy")}
            if hasattr(importlib.import_module(_MODULE), "LAUNCHES_BWD") else {})


def composite_bwd_bytes(n: int, s: int, c: int, itemsize: int, dsigma: bool, dradiance: bool) -> float:
    """Each tensor the kernel's interface reads or writes, once: sigma,
    depths, the radiance and the mask read a sample, dsigma (f32) and the
    radiance's gradient written where wanted; the direction norm, the
    colour's, depth's and acc's gradients read a ray."""
    per_sample = 4 + 4 + c * itemsize + 1 + (4 if dsigma else 0) + (c * itemsize if dradiance else 0)
    per_ray = 4 + 4 * c + 4 + 4
    return float(per_sample) * n * s + float(per_ray) * n


def read(trace):
    shapes = trace.counters.get("composite_bwd_shapes")
    if shapes is None or len(shapes) != 1:
        return None
    (shape,) = shapes
    bound_s = composite_bwd_bytes(*shape) / PEAK_HBM_BYTES_PER_S
    return roofline(trace, "composite_bwd_kernel", trace.counters["composite_bwd_launches"], bound_s)
