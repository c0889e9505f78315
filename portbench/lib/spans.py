"""A profiled window's device operations and idle gaps laid to the program's
spans: the `voxe.*` user annotations that the program's tracing module
(`utils/tracing.py`) enters under torch.profiler.

A device operation (kernel, copy, fill) is laid so:

1. its launch: the `cuda_runtime` or `cuda_driver` event with the same
   `correlation`;
2. the innermost host operator (`cpu_op`) running at that launch on the
   launching thread;
3. while that operator sits inside an autograd backward operator (one with
   a `Sequence number` and a `Fwd thread id`), the forward operator that made
   the node: the same sequence number on the forward thread, the last to
   start before it; and again from there, since the compositing backward
   re-differentiates its plain version inside a backward;
4. the innermost `voxe.*` span running at that operator's middle, or at the
   launch where no backward was found, on any thread: the autograd engine's
   threads run the backward while the step's thread waits inside its
   `voxe.backward`.

An operation with no launch event is `unattributed`; one laid to no span,
`outside`. Each idle gap between device operations, in `trace.reduce`'s
window, is laid to the innermost `voxe.*` span at its middle.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import Counter, defaultdict
from pathlib import Path
from typing import Dict, List

from portbench.lib.trace import DEVICE_CATS, _union

PREFIX = "voxe."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
DEPTH = 8  # backward-to-forward hops followed


class _Thread:
    """One thread's host operators, sorted by start, with parent links."""

    def __init__(self, ops: List[dict]):
        ops.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0))))
        self.ops = ops
        self.starts = [float(e["ts"]) for e in ops]
        self.parent = [-1] * len(ops)
        stack: List[int] = []
        for i, e in enumerate(ops):
            t = self.starts[i]
            while stack and _end(ops[stack[-1]]) < t:
                stack.pop()
            self.parent[i] = stack[-1] if stack else -1
            stack.append(i)

    def innermost(self, t: float) -> int:
        """The innermost operator running at `t`, or -1."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and _end(self.ops[i]) < t:
            i = self.parent[i]
        return i


def _end(e: dict) -> float:
    return float(e["ts"]) + float(e.get("dur", 0.0))


def _fwd_tid(e: dict) -> int:
    return int(e.get("args", {}).get("Fwd thread id", 0) or 0)


def _seq(e: dict) -> int:
    return int(e.get("args", {}).get("Sequence number", -1))


class _Spans:
    """The `voxe.*` annotations of every thread, innermost-at-a-time."""

    def __init__(self, events: List[dict]):
        self.spans = sorted(((float(e["ts"]), _end(e), e["name"]) for e in events), key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]

    def at(self, t: float) -> str:
        """The innermost span running at `t` (the last started that had
        not ended), or "outside"."""
        for i in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            if self.spans[i][1] >= t:
                return self.spans[i][2]
        return "outside"


def lay(events: List[dict]) -> dict:
    """{"span_device_s": {span: device seconds}, "span_idle_s": {span: idle
    seconds}, "device_s": the operations' summed seconds, "busy_s": their
    union, "unattributed_s", "outside_s"} from a Chrome trace's events."""
    device, launches, by_tid, spans = [], {}, defaultdict(list), []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            device.append(e)
        elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = e
        elif cat == "cpu_op":
            by_tid[e.get("tid")].append(e)
        elif cat == "user_annotation" and e["name"].startswith(PREFIX):
            spans.append(e)
    threads = {tid: _Thread(ops) for tid, ops in by_tid.items()}
    where = _Spans(spans)
    forward = _forward_index(threads)

    def anchor(tid, i: int):
        """(thread, operator) of the forward work behind operator i."""
        for _ in range(DEPTH):
            th = threads[tid]
            j = i
            while j >= 0 and _fwd_tid(th.ops[j]) <= 0:
                j = th.parent[j]
            if j < 0:
                return tid, i
            found = forward(th.ops[j])
            if found is None:
                return tid, i
            tid, i = found
        return tid, i

    laid: Dict[str, float] = defaultdict(float)
    memo: Dict[tuple, str] = {}
    for e in device:
        dur = float(e.get("dur", 0.0)) * 1e-6
        launch = launches.get(e.get("args", {}).get("correlation"))
        th = threads.get(launch.get("tid")) if launch is not None else None
        if th is None:
            laid["unattributed"] += dur
            continue
        t = float(launch["ts"])
        i = th.innermost(t)
        key = (launch.get("tid"), i, t if i < 0 else None)
        if key not in memo:
            if i < 0:
                memo[key] = where.at(t)
            else:
                tid, j = anchor(launch.get("tid"), i)
                op = threads[tid].ops[j]
                memo[key] = where.at(t if (tid, j) == (launch.get("tid"), i) else float(op["ts"]) + 0.5 * float(
                    op.get("dur", 0.0)))
        laid[memo[key]] += dur

    idle: Dict[str, float] = defaultdict(float)
    intervals = [(float(e["ts"]), _end(e)) for e in device]
    merged = _union(intervals)
    cpu_all = [e for th in threads.values() for e in th.ops]
    if merged and cpu_all:
        start = min(float(e["ts"]) for e in cpu_all)
        end = max(max(_end(e) for e in cpu_all), merged[-1][1])
        edges = [start] + [x for iv in merged for x in iv] + [end]
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 > g0:
                idle[where.at(0.5 * (g0 + g1))] += (g1 - g0) * 1e-6
    device_s = sum(float(e.get("dur", 0.0)) for e in device) * 1e-6
    return {
        "span_device_s": {k: v for k, v in laid.items() if k.startswith(PREFIX)},
        "span_idle_s": dict(idle),
        "device_s": device_s,
        "busy_s": sum(b - a for a, b in merged) * 1e-6,
        "unattributed_s": laid.get("unattributed", 0.0),
        "outside_s": laid.get("outside", 0.0),
    }


def _forward_index(threads: Dict[object, _Thread]):
    """A lookup from a backward operator to (thread, index) of the forward
    operator that made its node. Forward operators carry their sequence
    number but not the profiler's id of their thread; backward operators
    carry that id as `Fwd thread id`. Each id is matched to the thread where
    most of its backward operators' sequence numbers were made alone."""
    by_seq = defaultdict(list)  # seq -> [(start, tid, index)]
    for tid, th in threads.items():
        for i, e in enumerate(th.ops):
            if _seq(e) >= 0 and _fwd_tid(e) <= 0:
                by_seq[_seq(e)].append((th.starts[i], tid, i))
    for v in by_seq.values():
        v.sort(key=lambda x: x[0])
    votes = defaultdict(Counter)
    for th in threads.values():
        for e in th.ops:
            if _fwd_tid(e) > 0 and _seq(e) >= 0:
                tids = {tid for s, tid, _ in by_seq.get(_seq(e), ()) if s < float(e["ts"])}
                if len(tids) == 1:
                    votes[_fwd_tid(e)][tids.pop()] += 1
    tid_of = {f: c.most_common(1)[0][0] for f, c in votes.items()}

    def forward(e: dict):
        t, want = float(e["ts"]), tid_of.get(_fwd_tid(e))
        best = None
        for s, tid, i in by_seq.get(_seq(e), ()):
            if s >= t:
                break
            if want is None or tid == want:
                best = (tid, i)
        return best

    return forward


def host_times(records) -> Dict[str, tuple]:
    """{span: (calls, inclusive s, self s, s in `sync.*` spans inside it)}
    from the program's recorded spans, (name, parent index, t0 ns, t1 ns)
    each, as its tracing module's `take()` returns them."""
    n = len(records)
    children, syncs = [0] * n, [0] * n
    for i in range(n - 1, -1, -1):  # children come after their parent
        name, parent, t0, t1 = records[i]
        if name.startswith("sync."):
            syncs[i] = t1 - t0
        if parent >= 0:
            children[parent] += t1 - t0
            syncs[parent] += syncs[i]
    out: Dict[str, list] = {}
    for i, (name, _, t0, t1) in enumerate(records):
        c = out.setdefault(name, [0, 0, 0, 0])
        c[0] += 1
        c[1] += t1 - t0
        c[2] += t1 - t0 - children[i]
        c[3] += syncs[i] if not name.startswith("sync.") else 0
    return {k: (c[0], c[1] * 1e-9, c[2] * 1e-9, c[3] * 1e-9) for k, c in out.items()}


def profile_events(step, steps: int):
    """(the Chrome trace events, the seconds the calls took) of `steps`
    calls of `step` under torch.profiler (host and device), as
    `trace.profile` takes them."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with torch_profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        sync()
        seconds = time.perf_counter() - t0
    fd, name = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(name)
        return json.loads(Path(name).read_text())["traceEvents"], seconds
    finally:
        os.unlink(name)
