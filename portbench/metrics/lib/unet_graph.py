"""The program's counters of its SD UNet passes, `UNET_CALLS` (calls of
`StableDiffusion.unet_noise_pred`) and `UNET_REPLAYS` (those that replayed
a CUDA graph of the pass), of voxe_tpu_torch's tracing module, for a
metric's COUNTERS: `("portbench.metrics.lib.unet_graph", "UNET_CALLS",
"delta")`. A program without them reads 0 here and `present()` is false,
so the reader below returns None and the harness leaves its metrics out."""
from __future__ import annotations

import importlib
from typing import Optional

MODULE = "voxe_tpu_torch.utils.tracing"
NAMES = ("UNET_CALLS", "UNET_REPLAYS")


def _program():
    try:
        return importlib.import_module(MODULE)
    except ModuleNotFoundError:
        return None


def present() -> bool:
    program = _program()
    return program is not None and all(hasattr(program, name) for name in NAMES)


def __getattr__(name: str):
    if name not in NAMES:
        raise AttributeError(name)
    return getattr(_program(), name) if present() else 0


def replay_pct(trace) -> Optional[float]:
    """The share of the profiled steps' UNet calls that replayed a graph,
    in %; None without the counters or without a UNet call."""
    calls = trace.counters["unet_calls"]
    if not present() or calls == 0:
        return None
    return 100.0 * trace.counters["unet_replays"] / calls
