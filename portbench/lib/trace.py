"""The traced sub-window: a fixed number of steps under torch.profiler,
reduced from its Chrome trace to what the per-layer readers take.

Device time is the union of the device operations' intervals (kernels,
copies, fills), so operations that overlap on two streams count once. The
window runs from the first host operator of the profiled steps to the end
of the last device operation. Each idle gap between device operations is
laid to the innermost host operator running at its middle.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
WALK = 4096  # host operators searched back from a gap


@dataclass
class Trace:
    """What a per-layer reader reads."""

    kernels: List[Tuple[str, float, float]]  # (name, start us, duration us), kernels only
    busy_s: float
    window_s: float
    steps: int
    ms_per_step: float  # of the untraced window, before the profiler started
    counters: Dict[str, object]  # program counters: deltas over the profiled steps, or values after them
    config: dict
    cell: dict


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def _host_at(cpu_ops: List[Tuple[str, float, float]], starts: List[float], t: float) -> str:
    """The innermost host operator running at `t`: of those that started by
    `t` and had not ended, the one that started last (`cpu_ops` sorted by
    start, `starts` their starts)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - WALK, -1), -1):
        name, s, d = cpu_ops[j]
        if s + d >= t:
            return name
    return "host: no operator"


def reduce(events: List[dict]) -> dict:
    """Kernels, device busy seconds, window seconds and the breakdown from a
    Chrome trace's complete events."""
    device, kernels, cpu_ops = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((e["name"], ts, dur))
            if cat == "kernel":
                kernels.append((e["name"], ts, dur))
        elif cat == "cpu_op":
            cpu_ops.append((e["name"], ts, dur))
    if not device or not cpu_ops:
        return {"kernels": kernels, "busy_s": 0.0, "window_s": 0.0, "breakdown": {}}
    start = min(s for _, s, _ in cpu_ops)
    end = max(s + d for _, s, d in device + cpu_ops)
    merged = _union([(s, s + d) for _, s, d in device])
    busy = sum(e - s for s, e in merged)
    by_op = defaultdict(float)
    for name, _, dur in device:
        by_op[name[:160]] += dur * 1e-6
    cpu_ops.sort(key=lambda op: op[1])
    starts = [s for _, s, _ in cpu_ops]
    gaps = defaultdict(float)
    edges = [start] + [x for iv in merged for x in iv] + [end]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 > g0:
            gaps[_host_at(cpu_ops, starts, 0.5 * (g0 + g1))[:160]] += (g1 - g0) * 1e-6
    breakdown = {
        "device_ops": sorted(([k, v] for k, v in by_op.items()), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:TOP],
    }
    return {"kernels": kernels, "busy_s": busy * 1e-6, "window_s": (end - start) * 1e-6, "breakdown": breakdown}


def profile(step, steps: int) -> dict:
    """Run `step` `steps` times under torch.profiler (host and device) and
    reduce its trace. The trace file goes to TMPDIR and is deleted."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    fd, name = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(name)
        events = json.loads(Path(name).read_text())["traceEvents"]
    finally:
        os.unlink(name)
    return reduce(events)
