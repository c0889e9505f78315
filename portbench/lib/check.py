"""The comparison that decides `correct`.

Set-up drives the program's own training step, the one object the window
then runs, through its first three steps, and reads: each step's loss, the
norm of each leaf's first gradient as the optimizer got it (Adam's first
moment after one step, over 1 - b1), and the norm of each leaf's change
over the three steps. The plain reference follows the same three steps from
the same inputs. Three numbers are compared, each against the cell's limit:

- `loss_gap`: the widest |program - reference| over the steps' losses, over
  the larger of the reference's loss and the median of its losses;
- `grad_gap`: the widest gap between the program's and the reference's
  first-gradient norms over the leaves, each over the larger of the
  reference's norm of that leaf and the median leaf's;
- `change_gap`: the same for the change over three steps, over the leaves
  whose reference gradient is at least a thousandth of the median leaf's
  (a leaf below that moves under Adam by rounding alone).

A cell compares the numbers its workload file gives a limit.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List

import torch

BETA1 = 0.9
STEPS = 3
NUMBERS = ("loss_gap", "grad_gap", "change_gap")


def _flat(losses) -> List[float]:
    out = []
    for item in losses:
        out.extend(item if isinstance(item, (tuple, list)) else [item])
    return [float(x) for x in out]


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def _first_norm(first_moment, name: str) -> float:
    try:
        return _norm(first_moment(name))
    except KeyError:  # an optimizer that never updated holds no moment: a zero gradient
        return 0.0


def program_readings(step, leaves: Dict[str, torch.Tensor], first_moment) -> dict:
    """Run `step` (returns the step's loss, a float or a tuple of floats)
    three times and read the program's numbers. `first_moment(name)` is the
    optimizer's first moment of the leaf after the first step."""
    start = {k: v.detach().clone() for k, v in leaves.items()}
    losses, grad = [], {}
    for i in range(STEPS):
        losses.append(step())
        if i == 0:
            grad = {k: _first_norm(first_moment, k) / (1.0 - BETA1) for k in leaves}
    change = {k: _norm(v.detach() - start[k]) for k, v in leaves.items()}
    del start
    return {"loss": losses, "grad_norm": grad, "change_norm": change}


def _leaf_gap(prog: dict, ref: dict, keys: Iterable[str]) -> float:
    keys = list(keys)
    median = statistics.median([ref[k] for k in keys])
    return max(abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30) for k in keys)


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The three compared numbers of a program's readings against the
    reference's (NaN where the program's are not finite)."""
    p_loss, r_loss = _flat(prog["loss"]), _flat(ref["loss"])
    scale = statistics.median(abs(x) for x in r_loss)
    loss_gap = max(abs(p - r) / max(abs(r), scale, 1e-30) for p, r in zip(p_loss, r_loss))
    g_med = statistics.median(ref["grad_norm"].values())
    moved = [k for k, g in ref["grad_norm"].items() if g >= 1e-3 * g_med]
    out = {
        "loss_gap": loss_gap,
        "grad_gap": _leaf_gap(prog["grad_norm"], ref["grad_norm"], ref["grad_norm"]),
        "change_gap": _leaf_gap(prog["change_norm"], ref["change_norm"], moved),
    }
    finite = all(math.isfinite(x) for x in p_loss + list(prog["grad_norm"].values()) +
                 list(prog["change_norm"].values()))
    return out if finite else {k: math.nan for k in out}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number that the cell compares (has a limit for) finite and
    within its limit."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= limit for k, limit in limits.items())
