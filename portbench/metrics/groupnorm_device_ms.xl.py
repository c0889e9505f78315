"""Device ms a step of the SD stack's GroupNorm kernels
(voxe_tpu_torch/csrc/group_norm.cu): the kernels whose name holds
`group_norm` in the profiled steps, summed and laid over the steps. The
program's call counter times the kernels a call launches must agree with the
kernels found. A program without the kernel (no
`voxe_tpu_torch.ops.group_norm`) asks for no counter and reads None."""
import importlib
import importlib.util
import sys

_MODULE = "voxe_tpu_torch.ops.group_norm"
COUNTERS = ({"group_norm_calls": (_MODULE, "LAUNCHES", "delta")}
            if importlib.util.find_spec(_MODULE) is not None else {})


def read(trace):
    calls = trace.counters.get("group_norm_calls")
    times = [dur for name, _, dur in trace.kernels if "group_norm" in name]
    if calls is None or not times:
        return None
    expected = calls * importlib.import_module(_MODULE).KERNELS_PER_CALL
    if len(times) != expected:
        print(f"portbench: {len(times)} group_norm kernels in the trace, the program's calls make {expected}",
              file=sys.stderr)
        return None
    return sum(times) * 1e-3 / trace.steps
