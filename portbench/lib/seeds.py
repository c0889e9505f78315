"""Everything a run draws comes from `--seed`: one stream per purpose,
named, so that adding a stream never shifts another."""
from __future__ import annotations

import zlib

import numpy as np
import torch


def sub_seed(seed: int, name: str) -> int:
    """A 63-bit seed for the stream `name` of run seed `seed` (any integer)."""
    return (int(seed) * 1_000_003 + zlib.crc32(name.encode())) % (2**63 - 1)


def generator(seed: int, name: str, device) -> torch.Generator:
    """A torch.Generator on `device` for the stream `name`."""
    return torch.Generator(device=torch.device(device)).manual_seed(sub_seed(seed, name))


def host_rng(seed: int, name: str) -> np.random.Generator:
    """A numpy Generator for host-side draws of the stream `name`."""
    return np.random.default_rng(sub_seed(seed, name))
