"""The program's self-attention FLOP counters by route, `ATTN_FLASH_FLOPS`,
`ATTN_SDPA_FLOPS` and `ATTN_PROBS_FLOPS` of voxe_tpu_torch's tracing module,
for a metric's COUNTERS: `("portbench.metrics.lib.attn_flops",
"ATTN_FLASH_FLOPS", "delta")`. A program without them reads 0 here and
`present()` is false, so the reader below returns None and the harness
leaves its metric out."""
from __future__ import annotations

import importlib
from typing import Optional

MODULE = "voxe_tpu_torch.utils.tracing"
NAMES = ("ATTN_FLASH_FLOPS", "ATTN_SDPA_FLOPS", "ATTN_PROBS_FLOPS")


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


def flash_pct(trace) -> Optional[float]:
    """The flash kernel's share of the profiled steps' self-attention
    FLOPs, in %; None without the counters or without a self-attention."""
    c = trace.counters
    total = c["attn_flash_flops"] + c["attn_sdpa_flops"] + c["attn_probs_flops"]
    if not present() or total == 0:
        return None
    return 100.0 * c["attn_flash_flops"] / total
