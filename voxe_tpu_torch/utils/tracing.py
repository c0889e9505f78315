"""Program spans and the program counters.

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
`span("sync." + site)`. `UNET_CALLS` counts the calls of SD's no-grad UNet
pass (`StableDiffusion.unet_noise_pred`), and `UNET_REPLAYS` those of them
that replayed a CUDA graph of the pass instead of dispatching it.
`ATTN_FLASH_FLOPS`, `ATTN_SDPA_FLOPS` and `ATTN_PROBS_FLOPS` count the UNet
self-attentions' FLOPs (q k^T and p v, 4 B Q K C, from the shapes) by the
route each call took: the flash kernel, the library's SDPA or the f32 probs
path.

These and the kernel modules' counters are the program counters
(`COUNTERS`): module-level ints (`composite.LAUNCHED_SHAPES` a set) that
only `count` raises, that the program never resets and that readers take as
deltas (`counted`). A call counted on a card while its current stream is
being captured into a CUDA graph adds to the capture's tally (`captured`)
instead, and the graph's owner adds the tally at each replay (`replayed`),
so a replay counts what the same calls would count eagerly.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import sys
import time
from typing import List, Optional, Tuple

import torch

SYNCS = 0  # calls made through `synced`, `scalar` and `upload`
SYNC_NS = 0  # host nanoseconds spent inside them
UNET_CALLS = 0  # calls of StableDiffusion.unet_noise_pred
UNET_REPLAYS = 0  # of those, the calls that replayed a CUDA graph
ATTN_FLASH_FLOPS = 0  # UNet self-attention FLOPs that ran through the flash kernel
ATTN_SDPA_FLOPS = 0  # ... through the library's scaled_dot_product_attention
ATTN_PROBS_FLOPS = 0  # ... through the f32 probs path (capture or the probs-edit hook)

_MODULES = {"flash_attention": "voxe_tpu_torch.ops.flash_attention", "group_norm": "voxe_tpu_torch.ops.group_norm",
            "composite": "voxe_tpu_torch.ops.composite", "tracing": __name__}
COUNTERS = (  # "module.NAME" of every program counter
    "flash_attention.LAUNCHES", "flash_attention.LAUNCHES_BWD", "flash_attention.REFERENCE_ON_CUDA",
    "group_norm.LAUNCHES", "group_norm.REFERENCE_ON_CUDA", "composite.LAUNCHES", "composite.LAUNCHED_SHAPES",
    "composite.LAUNCHES_SUMS", "composite.LAUNCHES_BWD", "composite.LAUNCHED_BWD_SHAPES",
    "tracing.SYNCS", "tracing.SYNC_NS", "tracing.UNET_CALLS", "tracing.UNET_REPLAYS",
    "tracing.ATTN_FLASH_FLOPS", "tracing.ATTN_SDPA_FLOPS", "tracing.ATTN_PROBS_FLOPS",
)
_tally: Optional[dict] = None  # the open capture's counts (`captured`)

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
    count("tracing.SYNCS")
    t0 = time.perf_counter_ns()
    with span("sync." + site):
        out = fn()
    count("tracing.SYNC_NS", time.perf_counter_ns() - t0)
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


def _home(name: str):
    """(module, attribute) of the counter `name`, importing the module if no
    one has yet."""
    module, attr = name.split(".")
    path = _MODULES[module]
    return sys.modules.get(path) or importlib.import_module(path), attr


def _plus(old, value):
    return old | value if isinstance(old, set) else old + value


def count(name: str, value=1, device: Optional[torch.device] = None) -> None:
    """Add `value` to the program counter `name` (a set of new members for a
    set counter). A call on a card (`device`) whose current stream is being
    captured adds to the open capture's tally instead; a call without a card
    never asks CUDA. A counter is replaced, never changed in place."""
    if device is not None and device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        if _tally is None:
            raise RuntimeError(f"{name}: counted inside a CUDA graph capture without tracing.captured()")
        _tally[name] = _plus(_tally[name], value) if name in _tally else value
        return
    module, attr = _home(name)
    setattr(module, attr, _plus(getattr(module, attr), value))


@contextlib.contextmanager
def captured():
    """The tally of one CUDA graph capture, {counter: value}:
    `with tracing.captured() as tally, torch.cuda.graph(graph): ...`."""
    global _tally
    _tally = tally = {}
    try:
        yield tally
    finally:
        _tally = None


def replayed(tally: dict) -> None:
    """Count one replay of a graph whose capture filled `tally`."""
    for name, value in tally.items():
        count(name, value)


def _value(name: str):
    module, attr = _home(name)
    return getattr(module, attr)


class counted:
    """The change of every program counter over a block:
    `with tracing.counted() as c: ...`, then `c["group_norm.LAUNCHES"]` (a
    set counter's new members). Read inside the block, the change so far."""

    def __enter__(self):
        self._start, self._end = {name: _value(name) for name in COUNTERS}, None
        return self

    def __exit__(self, *exc):
        self._end = {name: _value(name) for name in COUNTERS}
        return False

    def __getitem__(self, name: str):
        return (_value(name) if self._end is None else self._end[name]) - self._start[name]
