"""The program's host-sync counters, `SYNCS` (calls that make the host wait
for the card: a device value read, a blocking copy of host values) and
`SYNC_NS` (the host's nanoseconds inside them), of voxe_tpu_torch's
tracing module, for a metric's COUNTERS: `("portbench.metrics.lib.syncs",
"SYNCS", "delta")`. A program without that module reads 0 here and
`present()` is false, so the readers below return None and the harness
leaves their metrics out."""
from __future__ import annotations

import importlib
from typing import Optional

MODULE = "voxe_tpu_torch.utils.tracing"
NAMES = ("SYNCS", "SYNC_NS")


def _program():
    try:
        return importlib.import_module(MODULE)
    except ModuleNotFoundError:
        return None


def present() -> bool:
    return _program() is not None


def __getattr__(name: str):
    if name not in NAMES:
        raise AttributeError(name)
    program = _program()
    return 0 if program is None else getattr(program, name)


def syncs_per_step(trace) -> Optional[float]:
    """Host syncs a step over the profiled steps."""
    if not present():
        return None
    return trace.counters["host_syncs"] / trace.steps


def sync_wait_ms(trace) -> Optional[float]:
    """The host's ms a step inside its syncs over the profiled steps: the
    time it waited for the card's queue to drain."""
    if not present():
        return None
    return trace.counters["sync_wait_ns"] * 1e-6 / trace.steps
