"""Training-state checkpointing: named tensors (the grid and its Adam
state) plus a JSON progress record in one npz file
(counterpart of voxe_tpu/train/checkpointing.py in the port's own layout).

Keys are `leaf::<name>`; `__meta__` holds the JSON. Loading an optax state
written by the JAX package, and resuming a run from this file, are not
ported yet.
"""
from __future__ import annotations

import io
import json
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch


def adam_state_tensors(grid, optimizer: torch.optim.Optimizer) -> Dict[str, torch.Tensor]:
    """The grid and its Adam moments as named tensors."""
    named = {"grid/densities": grid.densities, "grid/features": grid.features}
    for name, param in (("densities", grid.densities), ("features", grid.features)):
        for k, v in optimizer.state.get(param, {}).items():
            named[f"opt/{name}/{k}"] = torch.as_tensor(v)
    return named


def save_training_state(path: Path, tensors: Dict[str, torch.Tensor], metadata: Dict[str, Any]) -> None:
    """Write named tensors + JSON metadata as one npz file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {f"leaf::{k}": v.detach().cpu().numpy() for k, v in tensors.items()}
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(json.dumps(metadata).encode(), dtype=np.uint8), **arrays)
    path.write_bytes(buf.getvalue())


def load_training_state(path: Path) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """(named arrays, metadata) from `save_training_state`'s file."""
    with np.load(Path(path), allow_pickle=False) as data:
        metadata = json.loads(bytes(data["__meta__"].tobytes()).decode())
        arrays = {k[len("leaf::"):]: np.array(data[k]) for k in data.files if k.startswith("leaf::")}
    return arrays, metadata
