"""Program spans and the host-sync counter.

`span(name)` marks one layer's work: the shear-warp render, SD's VAE encode,
UNet and token maps, a trainer step and its draw, loss, backward and
optimizer parts. It costs two flag reads when nothing listens. Under
`torch.profiler` it enters `record_function("voxe." + name)`, so the span
lands in the Chrome trace on the device operations' clock and every kernel
and idle gap can be laid to it; with recording on (`record(True)`) it also
appends (name, parent index, t0 ns, t1 ns) on the host's `perf_counter_ns`
clock, which `take()` hands over. Spans are entered from the thread that
drives the step.

Each call on a step's path that makes the host wait for the card goes
through `scalar(x, site)` (a device value read on the host), `upload(values,
site)` (host values copied to the card: a blocking copy from pageable
memory, which waits for the stream to drain) or, for a library call that
reads a device value inside, `synced(site, fn)`. Each counts one in `SYNCS`,
adds the host time it took to `SYNC_NS` and runs inside
`span("sync." + site)`. The counters follow the launch counters' convention
(`ops/flash_attention.py::LAUNCHES`): always counted, never reset by the
program, read as deltas. So do `UNET_CALLS`, the calls of SD's no-grad
UNet pass (`StableDiffusion.unet_noise_pred`), and `UNET_REPLAYS`, those of
them that replayed a CUDA graph of the pass instead of dispatching it.

`ATTN_FLASH_FLOPS`, `ATTN_SDPA_FLOPS` and `ATTN_PROBS_FLOPS` count the UNet
self-attentions' FLOPs (q k^T and p v, 4 B Q K C, from the shapes) by the
route each call took: the flash kernel, the library's SDPA or the f32 probs
path (`count_attention`). A call recorded into a CUDA graph counts in
`ATTN_CAPTURED` instead; the graph's owner adds what its capture recorded
at each replay (`count_replayed_attention`), as the flash kernel's
`LAUNCHES` / `CAPTURED` do.
"""
from __future__ import annotations

import functools
import time
from typing import List, Tuple

import torch

SYNCS = 0  # calls made through `synced`, `scalar` and `upload`
SYNC_NS = 0  # host nanoseconds spent inside them
UNET_CALLS = 0  # calls of StableDiffusion.unet_noise_pred
UNET_REPLAYS = 0  # of those, the calls that replayed a CUDA graph
ATTN_FLASH_FLOPS = 0  # UNet self-attention FLOPs that ran through the flash kernel
ATTN_SDPA_FLOPS = 0  # ... through the library's scaled_dot_product_attention
ATTN_PROBS_FLOPS = 0  # ... through the f32 probs path (capture or the probs-edit hook)
ATTN_CAPTURED = {"flash": 0, "sdpa": 0, "probs": 0}  # the same, recorded into CUDA graphs
_ATTN_NAMES = {"flash": "ATTN_FLASH_FLOPS", "sdpa": "ATTN_SDPA_FLOPS", "probs": "ATTN_PROBS_FLOPS"}

_recording = False
_records: List[list] = []  # [name, parent index or -1, t0 ns, t1 ns]
_open: List[int] = []  # indices into _records of the spans entered and not left


class _Null:
    """The shared context of a span nobody listens to."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL = _Null()


class _Span:
    __slots__ = ("name", "annotation", "index")

    def __init__(self, name: str, annotation):
        self.name, self.annotation, self.index = name, annotation, -1

    def __enter__(self):
        if self.annotation is not None:
            self.annotation.__enter__()
        if _recording:
            self.index = len(_records)
            _records.append([self.name, _open[-1] if _open else -1, time.perf_counter_ns(), 0])
            _open.append(self.index)
        return None

    def __exit__(self, *exc):
        if self.index >= 0:
            _records[self.index][3] = time.perf_counter_ns()
            _open.pop()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


def span(name: str):
    """A context manager for the layer `name`: `NULL` unless a profiler runs
    or recording is on."""
    profiling = torch.autograd._profiler_enabled()
    if not (profiling or _recording):
        return NULL
    return _Span(name, torch.profiler.record_function("voxe." + name) if profiling else None)


def traced(name: str):
    """Decorator: the whole call inside `span(name)`."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def record(on: bool) -> None:
    """Turn the host-clock recording of spans on or off."""
    global _recording
    _recording = bool(on)


def take() -> List[Tuple[str, int, int, int]]:
    """The spans recorded so far, as (name, parent index, t0 ns, t1 ns), and
    clear them. Call it between steps, with no span open."""
    if _open:
        raise RuntimeError(f"take() inside the open span {_records[_open[-1]][0]!r}")
    out = [tuple(r) for r in _records]
    _records.clear()
    return out


def synced(site: str, fn):
    """`fn()`, a call that makes the host wait for the card once."""
    global SYNCS, SYNC_NS
    SYNCS += 1
    t0 = time.perf_counter_ns()
    with span("sync." + site):
        out = fn()
    SYNC_NS += time.perf_counter_ns() - t0
    return out


def scalar(x: torch.Tensor, site: str):
    """`x.item()` for a 0-d tensor, else `x.cpu()`: a device value read on
    the host."""
    return synced(site, x.item if x.dim() == 0 else x.cpu)


def upload(values, site: str, *, dtype=None, device=None) -> torch.Tensor:
    """`torch.as_tensor(values, dtype=dtype, device=device)`, counted for
    host values (numbers, lists, arrays, CPU tensors); a tensor already on a
    card passes through uncounted."""
    if isinstance(values, torch.Tensor) and values.device.type != "cpu":
        return torch.as_tensor(values, dtype=dtype, device=device)
    return synced(site, lambda: torch.as_tensor(values, dtype=dtype, device=device))


def count_attention(route: str, flops: int, device: torch.device) -> None:
    """One self-attention call's FLOPs on `route` ("flash", "sdpa" or
    "probs"): into `ATTN_CAPTURED` while the card's current stream is being
    captured, else into the route's counter."""
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        ATTN_CAPTURED[route] += flops
    else:
        globals()[_ATTN_NAMES[route]] += flops


def count_replayed_attention(counts: dict) -> None:
    """A replay of a graph whose capture recorded `counts` ({route: FLOPs},
    the change of `ATTN_CAPTURED` over the capture)."""
    for route, flops in counts.items():
        globals()[_ATTN_NAMES[route]] += flops
