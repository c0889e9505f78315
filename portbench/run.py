"""The benchmark of voxe_tpu_torch on NVIDIA cards.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run of one cell of BENCHMARK.json, from the root of a checkout:

1. set-up: the cell's files (found by name), the program's model and state
   made on the card from the seed, the program's step driven through its
   first three steps (which are the warm-up of the cell's shapes and the
   readings that the check compares);
2. the window: the same step, back to back, for `--seconds`, then a
   synchronisation. With `--trace 1` a fixed number of further steps run
   under torch.profiler for the per-layer metrics;
3. the check: the program's state freed, the plain reference follows the
   same first three steps in float32 and the compared numbers are held to
   the cell's limits;
4. the result: the compared numbers beside their limits as the last lines of
   standard error, and one JSON line as the last line of standard output.

Without a card, or with fewer cards than the cell asks for, it exits 2 and
prints no result; it exits 3 if JAX, flax, optax or the JAX package was
loaded. Caches of compiled kernels stay inside the checkout
(`voxe_tpu_torch/_build/`, `portbench/.cache/`).
"""
from __future__ import annotations

import time

T0 = time.perf_counter()  # the process's start, as near as Python sees it

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Optional  # noqa: E402

from portbench.lib.manifest import BENCH, Cell, counters_of, reader  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "voxe_tpu")


def cache_dirs() -> None:
    """Fixed cache directories inside the checkout, set before the program
    is imported."""
    os.environ["TRITON_CACHE_DIR"] = str(BENCH / ".cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BENCH / ".cache" / "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's, optax's or the
    JAX package's (compared whole: voxe_tpu_torch is not voxe_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def _snapshot(counters: dict) -> dict:
    import copy
    import importlib

    return {k: copy.copy(getattr(importlib.import_module(mod), attr)) for k, (mod, attr, _) in counters.items()}


def _counter_values(counters: dict, before: dict, after: dict) -> dict:
    return {k: (after[k] - before[k] if how == "delta" else after[k]) for k, (_, _, how) in counters.items()}


def _e2e(cell: Cell, steps: int, window_s: float, setup_s: float, peak: int, units: int) -> dict:
    values = {
        "setup_s": setup_s,
        "peak_mem_gib": peak / 2**30,
        "ms_per_step": window_s * 1e3 / steps,
        "mega_units_per_s": steps * units / window_s / 1e6,
    }
    out = {}
    for m in cell.end_to_end():
        kind = m["name"] if m["name"] in ("setup_s", "peak_mem_gib") else cell.spec["end_to_end"][m["name"]]
        out[m["name"]] = {"value": values[kind], "unit": m["unit"]}
    return out


def run(name: str, seed: int, seconds: float, trace: bool, device, overrides: Optional[dict] = None):
    """One run of the cell on `device`; returns (result dict, compared
    numbers with their limits). The command-line entry checks the card
    first; tests call this on the CPU at a small size."""
    import torch

    from portbench.lib import check
    from portbench.lib import trace as tracing
    from portbench.reference.precision import Rounding

    cell = Cell(name, overrides=overrides)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    session = cell.entry.setup(cell.config, cell.spec, seed, device)
    sync()
    setup_s = time.perf_counter() - T0

    steps = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        session.step()
        steps += 1
    sync()
    window_s = time.perf_counter() - t0

    metrics, breakdown, device_info = {}, None, {}
    if trace:
        readers = {m["name"]: reader(m["name"]) for m in cell.per_layer()}
        counters = counters_of(readers)
        before = _snapshot(counters)
        prof = tracing.profile(session.step, int(cell.spec["trace_steps"]))
        values = _counter_values(counters, before, _snapshot(counters))
        tr = tracing.Trace(prof["kernels"], prof["busy_s"], prof["window_s"], int(cell.spec["trace_steps"]),
                           window_s * 1e3 / steps, values, cell.config, cell.spec)
        units = {m["name"]: m["unit"] for m in cell.per_layer()}
        for metric, module in readers.items():
            value = module.read(tr)
            if value is not None:
                metrics[metric] = {"value": value, "unit": units[metric]}
        breakdown = prof["breakdown"]
        device_info = {"busy_s": prof["busy_s"], "window_s": prof["window_s"]}

    peak = torch.cuda.max_memory_allocated() if cuda else 0
    finite = all(bool(torch.isfinite(v).all()) for v in session.leaves.values())
    if not trace:
        metrics = _e2e(cell, steps, window_s, setup_s, peak, int(session.units_per_step))
    readings = session.readings
    del session
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref = cell.entry.reference(cell.config, cell.spec, seed, device, Rounding("f32"))
    numbers = check.gaps(readings, ref)
    limits = cell.spec["limits"]
    compared = {k: {"value": numbers[k] if math.isfinite(numbers[k]) else None, "limit": limit}
                for k, limit in limits.items()}
    result = {
        "correct": check.judge(numbers, limits),
        "attempted": steps,
        "failed": 0 if finite else steps,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": peak,
            "power_limit_w": power_limit_w() if cuda else None,
            **device_info,
        },
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = compared
    return result, compared


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_dirs()

    import torch

    torch.set_num_threads(1)  # one host thread: no intra-op pool competing with the dispatching thread
    cell = Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, compared = run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded {found}; the benchmark runs the PyTorch port alone", file=sys.stderr)
        return 3
    for k, v in compared.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
