"""Training-state checkpointing (counterpart of
voxe_tpu/train/checkpointing.py): the grid, its Adam state and the draw
state in one npz file beside a JSON progress record, in the JAX package's
leaf layout, so either package resumes from the other's file.

Keys are `leaf::<path>` with the key-paths the JAX package writes for
`{"grid": grid, "opt_state": optax.adam(schedule).init(grid), "key": key}`:
`grid/0` (densities), `grid/1` (features), `opt_state/0/count`,
`opt_state/0/mu/{0,1}`, `opt_state/0/nu/{0,1}` (optax's ScaleByAdamState:
torch's `step`, `exp_avg`, `exp_avg_sq`), `opt_state/1/count` (the lr
schedule's count, which is the same update count) and `key`, a raw uint32[2]
PRNG key. `__meta__` holds the JSON. The port adds
`torch_generator/<device type>`, its `torch.Generator` state; the JAX
loader reads only the leaves of its template and ignores it.

A torch generator cannot replay a JAX key, so the rule between the two is
fixed: the port writes `key = [global_step, seed mod 2^32]` (its generator's
initial seed), and seeds its generator with `key[0] * 2^32 + key[1]` when a
file has no generator state for the device it resumes on (a JAX-written
file, or a stage that now runs on another device).
"""
from __future__ import annotations

import io
import json
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

_PARAMS = ("densities", "features")  # grid/0, grid/1: VoxelGrid's pytree order in the JAX package
GENERATOR_LEAF = "torch_generator"


def training_state_arrays(grid, optimizer: torch.optim.Optimizer, generator: torch.Generator,
                          global_step: int) -> Dict[str, np.ndarray]:
    """The grid, its Adam state, the JAX key and the generator state as the
    JAX package's named leaves (+ `torch_generator/<device type>`)."""
    arrays = {}
    count = 0
    for i, name in enumerate(_PARAMS):
        param = getattr(grid, name)
        arrays[f"grid/{i}"] = param.detach().cpu().numpy()
        state = optimizer.state.get(param, {})
        if state:
            count = int(state["step"])
        for leaf, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            value = state.get(key)
            arrays[f"opt_state/0/{leaf}/{i}"] = (
                np.zeros(param.shape, np.float32) if value is None else value.detach().cpu().numpy()
            )
    arrays["opt_state/0/count"] = arrays["opt_state/1/count"] = np.asarray(count, np.int32)
    arrays["key"] = np.asarray([global_step % 2**32, generator.initial_seed() % 2**32], np.uint32)
    arrays[f"{GENERATOR_LEAF}/{generator.device.type}"] = generator.get_state().numpy()
    return arrays


def save_training_state(path: Path, arrays: Dict[str, Any], metadata: Dict[str, Any]) -> None:
    """Write named arrays + JSON metadata as one npz file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(json.dumps(metadata).encode(), dtype=np.uint8),
             **{f"leaf::{k}": np.asarray(v) for k, v in arrays.items()})
    path.write_bytes(buf.getvalue())


def read_training_state(path: Path) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """(named arrays, metadata) of a training-state file of either package."""
    with np.load(Path(path), allow_pickle=False) as data:
        metadata = json.loads(bytes(data["__meta__"].tobytes()).decode())
        arrays = {k[len("leaf::"):]: np.array(data[k]) for k in data.files if k.startswith("leaf::")}
    return arrays, metadata


def seed_from_key(key) -> int:
    """The generator seed for a JAX key: its two words as one 64-bit number."""
    hi, lo = (int(w) for w in np.asarray(key, np.uint32).reshape(2))
    return (hi << 32) | lo


def load_training_state(path: Path, grid, optimizer: torch.optim.Optimizer,
                        generator: torch.Generator) -> Dict[str, Any]:
    """Restore a training state into a live grid (in place), its
    `torch.optim.Adam` (moments and step count) and `generator`; returns the
    metadata. Shapes must match the grid's."""
    arrays, metadata = read_training_state(path)
    count = int(arrays["opt_state/0/count"])
    if int(arrays["opt_state/1/count"]) != count:
        raise ValueError("training state: the lr-schedule count differs from Adam's (the port reads one count)")
    for i, name in enumerate(_PARAMS):
        param = getattr(grid, name)
        values = {k: arrays[f"{leaf}/{i}"] for k, leaf in (
            ("grid", "grid"), ("exp_avg", "opt_state/0/mu"), ("exp_avg_sq", "opt_state/0/nu"))}
        for k, v in values.items():
            if tuple(v.shape) != tuple(param.shape):
                raise ValueError(f"training state: {k} of {name} is {v.shape}, the grid's is {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.from_numpy(values["grid"]))
        optimizer.state[param] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.from_numpy(values["exp_avg"]).to(param.device),
            "exp_avg_sq": torch.from_numpy(values["exp_avg_sq"]).to(param.device),
        }
    state = arrays.get(f"{GENERATOR_LEAF}/{generator.device.type}")
    if state is not None:
        generator.set_state(torch.from_numpy(state))
    else:
        generator.manual_seed(seed_from_key(arrays["key"]))
    return metadata
