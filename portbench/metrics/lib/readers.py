"""The arithmetic the per-layer readers share. A reader that finds nothing
to read returns None, and the harness leaves its metric out."""
from __future__ import annotations

import sys
from typing import Optional

from portbench.metrics.lib.opcount import PEAK_BF16_FLOPS


def launches_per_step(trace) -> Optional[float]:
    if not trace.kernels:
        return None
    return len(trace.kernels) / trace.steps


def device_idle_pct(trace) -> Optional[float]:
    """Percent of the untraced window's time a step in which no device
    operation runs: the traced steps' device time a step (the union of the
    operations' intervals) against the time a step before the profiler
    started, since the profiler slows the host and not the device."""
    if trace.busy_s <= 0.0 or trace.ms_per_step <= 0.0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.steps / (trace.ms_per_step * 1e-3))


def step_mfu(trace, flops: float) -> Optional[float]:
    """Percent of the bf16 peak that the step's model FLOPs reach at the
    untraced window's time a step."""
    if trace.ms_per_step <= 0.0:
        return None
    return 100.0 * flops / (trace.ms_per_step * 1e-3 * PEAK_BF16_FLOPS)


def roofline(trace, kernel: str, launches: int, bound_s: float) -> Optional[float]:
    """Percent of its least time that the kernel's calls reach: the bound
    over the mean device time of the kernels whose name holds `kernel`.
    None where none ran, or where the program's counter disagrees with the
    kernels found (their time could not be laid to the right calls)."""
    times = [dur for name, _, dur in trace.kernels if kernel in name]
    if not times:
        return None
    if len(times) != launches:
        print(f"portbench: {len(times)} {kernel} kernels in the trace, the program counted {launches}",
              file=sys.stderr)
        return None
    return 100.0 * bound_s / (sum(times) * 1e-6 / len(times))
