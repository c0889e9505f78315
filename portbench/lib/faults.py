"""Faults planted under the timed path, to show that the check catches them.
A step that leaves its state unchanged is the same for every entry, and
lives here; each entry module names its own faults in a dict `FAULTS`
(every training entry has "half": its loss over the first half of its
batch's rows, the mean taken over those). The cells run on one card, so no
exchange between cards can be left out, and a training step produces no
token or answer to alter. Used by the benchmark's tests at a small size and
by `portbench.calibrate` on the card at the cells' own size."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def unchanged_state():
    """Every Adam update does nothing."""
    saved = torch.optim.Adam.step
    torch.optim.Adam.step = lambda self, closure=None: None
    try:
        yield
    finally:
        torch.optim.Adam.step = saved


def plant(entry, name: str):
    """The fault `name`: "unchanged", or one of the entry module's FAULTS."""
    if name == "unchanged":
        return unchanged_state()
    faults = getattr(entry, "FAULTS", {})
    if name not in faults:
        raise KeyError(f"no fault {name!r}; this entry has {sorted(faults) + ['unchanged']}")
    return faults[name]()


@contextlib.contextmanager
def patched(module, name: str, value):
    """`module.name` replaced by `value` while the context is open."""
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)
