"""Readings that the cells' limits are set from, on the card at the cells'
own sizes (not part of a benchmark run):

    python -m portbench.calibrate --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--fault unchanged --fault half ... --fault-seeds 7,8,9]

For each program seed, the program's first three steps against the float32
reference; for each control seed, the reference in float8 (the control)
against the reference in float32; for each fault named (`unchanged`, or one
of the entry module's FAULTS) and each fault seed, the program with the
fault planted against the reference. One JSON line a reading, the compared
numbers under "gaps"; the readings go to standard output.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from portbench.lib import check, faults
from portbench.lib.manifest import Cell
from portbench.reference.precision import Rounding


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def program(cell: Cell, seed: int, device, fault=None) -> dict:
    import contextlib

    with faults.plant(cell.entry, fault) if fault else contextlib.nullcontext():
        readings = cell.entry.setup(cell.config, cell.spec, seed, device).readings
    _free()
    return readings


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", action="append", default=[])
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = Cell(args.workload)
    runs = [("program", s, None) for s in _seeds(args.seeds)]
    runs += [("control", s, None) for s in _seeds(args.control_seeds)]
    runs += [(f"fault-{f}", s, f) for f in args.fault for s in _seeds(args.fault_seeds)]
    for kind, seed, fault in runs:
        t0 = time.perf_counter()
        if kind == "control":
            got = cell.entry.reference(cell.config, cell.spec, seed, args.device, Rounding("fp8"))
        else:
            got = program(cell, seed, args.device, fault)
        _free()
        ref = cell.entry.reference(cell.config, cell.spec, seed, args.device, Rounding("f32"))
        _free()
        print(json.dumps({"workload": cell.name, "kind": kind, "seed": seed, "gaps": check.gaps(got, ref),
                          "got": got, "ref": ref, "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
