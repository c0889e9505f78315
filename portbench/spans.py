"""Where a cell's step spends its time, by the program's spans.

    python3 -m portbench.spans --workload <cell> --seed <n> [--blocks 8] [--block_steps 5] [--out DIR]

On a card, from the root of a checkout, after the cell's set-up as
`portbench.run` makes it:

1. the cost of recording: blocks of `--block_steps` steps with the spans'
   host-clock recording off and on, in turns (off, on, on, off, ...), each
   ending in a synchronisation: ms a step of each block; the host syncs a
   step and the host's wait inside them (the program's `SYNCS`, `SYNC_NS`)
   over the blocks with recording off; each span's host time a step over
   the blocks with it on;
2. the cost of the annotations under torch.profiler: after one profiled
   step that is left out (the profiler's start-up), the cell's
   `trace_steps` profiled with the spans and with `span` returning its
   no-op, in turns (with, without, without, with): ms a step, device busy
   seconds and kernels of each (`trace.reduce`), and from the profiles with
   the spans, each span's device and idle seconds (`spans.lay`);
3. `trace_steps` steps under `torch.cuda.set_sync_debug_mode("warn")`: the
   synchronising calls that torch reports against the program's `SYNCS`.

Prints the spans' table and `span-idle <span> <ms a step>` lines (the ten
with the most idle time) to standard error, and one JSON line to standard
output, also written to DIR/<cell>.json with `--out`. Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
import warnings
from pathlib import Path
from unittest import mock


def _block(step, steps: int, sync) -> float:
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    sync()
    return (time.perf_counter() - t0) * 1e3 / steps


def measure(name: str, seed: int, blocks: int, block_steps: int, device="cuda", overrides=None) -> dict:
    """The three readings above; tests call it on the CPU at a small size,
    where no device operation and no sync debug mode exist."""
    import torch

    from portbench.lib import spans, trace
    from portbench.lib.manifest import Cell
    from voxe_tpu_torch.utils import tracing

    cell = Cell(name, overrides=overrides)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    session = cell.entry.setup(cell.config, cell.spec, seed, device)
    trace_steps = int(cell.spec["trace_steps"])
    sync()

    # 1. recording off and on, in turns
    ms = {False: [], True: []}
    syncs, sync_ns, off_steps, records = 0, 0, 0, []
    for on in [x for _ in range(blocks) for x in (False, True, True, False)][: 2 * blocks]:
        n0, w0 = tracing.SYNCS, tracing.SYNC_NS
        tracing.record(on)
        ms[on].append(_block(session.step, block_steps, sync))
        tracing.record(False)
        if on:
            records += tracing.take()
        else:
            syncs, sync_ns, off_steps = syncs + tracing.SYNCS - n0, sync_ns + tracing.SYNC_NS - w0, off_steps + block_steps
    on_steps = block_steps * len(ms[True])
    host = spans.host_times(records)

    # 2. profiled with the spans and without them, in turns
    profiled = {True: [], False: []}
    laid = []
    spans.profile_events(session.step, 1)  # the profiler's own start-up, left out
    for with_spans in (True, False, False, True):
        off = mock.patch.object(tracing, "span", lambda _name: tracing.NULL)
        with contextlib.nullcontext() if with_spans else off:
            events, seconds = spans.profile_events(session.step, trace_steps)
            wall_ms = seconds * 1e3 / trace_steps
        red = trace.reduce(events)
        profiled[with_spans].append({"ms_per_step": wall_ms, "busy_ms_per_step": red["busy_s"] * 1e3 / trace_steps,
                                     "kernels_per_step": len(red["kernels"]) / trace_steps})
        if with_spans:
            laid.append(spans.lay(events))
        del events

    # 3. torch's sync debug mode against the counter
    reported = 0

    def show(message, *args, **kwargs):
        nonlocal reported
        reported += "called a synchronizing" in str(message)

    sync()
    n0 = tracing.SYNCS
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(trace_steps):
                session.step()
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode("default")
    sync()
    counted = tracing.SYNCS - n0

    steps = trace_steps * len(laid)
    device_ms = {k: sum(d["span_device_s"].get(k, 0.0) for d in laid) * 1e3 / steps
                 for k in {k for d in laid for k in d["span_device_s"]}}
    idle_ms = {k: sum(d["span_idle_s"].get(k, 0.0) for d in laid) * 1e3 / steps
               for k in {k for d in laid for k in d["span_idle_s"]}}
    total = sum(d["device_s"] for d in laid)

    def sd(k):
        return k.startswith("voxe.sd.")

    table = {}
    for k in sorted(set(device_ms) | set(idle_ms) | {spans.PREFIX + h for h in host}):
        h = host.get(k[len(spans.PREFIX):], (0, 0.0, 0.0, 0.0)) if k.startswith(spans.PREFIX) else (0, 0.0, 0.0, 0.0)
        table[k] = {"device_ms": device_ms.get(k, 0.0), "idle_ms": idle_ms.get(k, 0.0), "calls": h[0] / on_steps,
                    "host_ms": h[1] * 1e3 / on_steps, "host_self_ms": h[2] * 1e3 / on_steps}
    return {
        "workload": name, "seed": seed, "card": torch.cuda.get_device_name(0) if cuda else "cpu",
        "ms_per_step": {"recording_off": ms[False], "recording_on": ms[True]},
        "host_syncs_per_step": syncs / off_steps,
        "sync_wait_ms": sync_ns * 1e-6 / off_steps,
        "sync_wait_ms_spans": sum(h[1] for k, h in host.items() if k.startswith("sync.")) * 1e3 / on_steps,
        "sd_host_ms": sum(h[1] - h[3] for k, h in host.items() if k.startswith("sd.")) * 1e3 / on_steps,
        "sd_device_ms": sum(v for k, v in device_ms.items() if sd(k)),
        "render_device_ms": device_ms.get("voxe.render", 0.0),
        "laid_share": sum(device_ms.values()) * 1e-3 * steps / total if total else None,
        "unattributed_share": sum(d["unattributed_s"] for d in laid) / total if total else None,
        "outside_share": sum(d["outside_s"] for d in laid) / total if total else None,
        "device_ms_per_step": total * 1e3 / steps,
        "busy_ms_per_step": sum(d["busy_s"] for d in laid) * 1e3 / steps,
        "profiled": {"with_spans": profiled[True], "without_spans": profiled[False]},
        "sync_debug": {"reported_per_step": reported / trace_steps, "counted_per_step": counted / trace_steps},
        "spans": table,
    }


def _pct(share) -> str:
    return "not measured" if share is None else f"{100 * share:.3f} %"


def report(r: dict) -> None:
    err = sys.stderr
    off, on = r["ms_per_step"]["recording_off"], r["ms_per_step"]["recording_on"]
    print(f"{r['workload']} on {r['card']}: {statistics.median(off):.3f} ms a step recording off, "
          f"{statistics.median(on):.3f} on; host syncs {r['host_syncs_per_step']:.2f} a step "
          f"(sync debug mode: {r['sync_debug']['reported_per_step']:.2f}), wait {r['sync_wait_ms']:.3f} ms", file=err)
    print(f"device {r['device_ms_per_step']:.3f} ms a step (union {r['busy_ms_per_step']:.3f}); laid to spans "
          f"{_pct(r['laid_share'])}, unattributed {_pct(r['unattributed_share'])}, outside "
          f"{_pct(r['outside_share'])}", file=err)
    print(f"{'span':32s} {'device ms':>10s} {'idle ms':>9s} {'host ms':>9s} {'self ms':>9s} {'calls':>6s}", file=err)
    for k, v in sorted(r["spans"].items(), key=lambda kv: -kv[1]["device_ms"] - kv[1]["idle_ms"]):
        print(f"{k:32s} {v['device_ms']:10.3f} {v['idle_ms']:9.3f} {v['host_ms']:9.3f} {v['host_self_ms']:9.3f} "
              f"{v['calls']:6.2f}", file=err)
    idle = sorted(((k, v["idle_ms"]) for k, v in r["spans"].items() if k.startswith("voxe.")), key=lambda kv: -kv[1])
    for k, v in idle[:10]:
        print(f"span-idle {k} {v!r}", file=err)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--blocks", type=int, default=8, help="blocks of each kind, recording off and on")
    p.add_argument("--block_steps", type=int, default=5)
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)

    from portbench.run import cache_dirs

    cache_dirs()
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("portbench.spans: needs a CUDA card", file=sys.stderr)
        return 2
    r = measure(args.workload, args.seed, args.blocks, args.block_steps)
    report(r)
    line = json.dumps(r)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / f"{args.workload}.json").write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
