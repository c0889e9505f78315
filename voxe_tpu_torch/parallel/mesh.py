"""Data-parallel ray batching over `torch.distributed` (counterpart of
voxe_tpu/parallel/mesh.py).

One process per device. The grid and the optimizer state are replicated on
every rank; each rank takes its share of a ray batch (`shard_rays`) or of
the shear-warp base rows (`shard_axis`), and one SUM all-reduce of the
gradients between `backward()` and the optimizer step gives every rank the
unsharded step's gradient, so Adam's state stays equal without a
broadcast. The JAX package gets the same step from GSPMD, which inserts the
gradient psum and the gathers itself; here `all_reduce_grads` and
`gather_axis` do that work by hand.

Shares follow `torch.tensor_split`: an uneven count gives the first
`n % world` ranks one item more.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

RAY_AXIS = "rays"  # the JAX mesh's one axis; a process group names none


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D ray mesh: the process group, this process's rank in it, the
    world size and the device its collectives run on. `calls` counts the
    collectives each helper issued."""

    group: Any
    rank: int
    size: int
    device: torch.device
    calls: Counter = dataclasses.field(default_factory=Counter, compare=False, repr=False)


def make_mesh(num_devices: Optional[int] = None) -> Mesh:
    """The mesh over the initialised default group, which must hold exactly
    `num_devices` processes (default: all of them); its device is this
    process's CUDA device on NCCL and the CPU on gloo."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (maybe_init_distributed, or torchrun)")
    world = dist.get_world_size()
    if num_devices is None:
        num_devices = world
    if num_devices > world:
        raise ValueError(f"requested {num_devices} devices, only {world} available")
    if num_devices != world:
        raise ValueError(f"requested {num_devices} devices, but the process group holds {world} processes")
    on_nccl = dist.get_backend() == "nccl"
    device = torch.device("cuda", torch.cuda.current_device()) if on_nccl else torch.device("cpu")
    return Mesh(group=dist.group.WORLD, rank=dist.get_rank(), size=world, device=device)


def maybe_mesh(num_devices: int = 1) -> Optional[Mesh]:
    """The trainers' entry: None (single-device semantics) for
    num_devices <= 1, else the mesh over that many processes."""
    if num_devices <= 1:
        return None
    return make_mesh(num_devices)


def shard_bounds(mesh: Mesh, n: int) -> Tuple[int, int]:
    """[lo, hi) of this rank's share of n items (`torch.tensor_split`)."""
    q, r = divmod(n, mesh.size)
    lo = mesh.rank * q + min(mesh.rank, r)
    return lo, lo + q + (1 if mesh.rank < r else 0)


def shard_axis(mesh: Mesh, value: torch.Tensor, axis: int) -> torch.Tensor:
    """This rank's share of `value` along `axis` (a view: autograd flows
    through it). The shear-warp renderer shards its base rows with it."""
    lo, hi = shard_bounds(mesh, value.shape[axis])
    return value.narrow(axis, lo, hi - lo)


def shard_rays(mesh: Mesh, value: torch.Tensor) -> torch.Tensor:
    """This rank's share of a per-ray tensor (leading dim = rays)."""
    return shard_axis(mesh, value, 0)


def replicate(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """Broadcast rank 0's tensors into every rank's, in place; returns
    them. The trainers call it once at start, so the replicated state starts
    equal."""
    for t in tensors:
        dist.broadcast(t.detach(), src=0, group=mesh.group)
    mesh.calls["replicate"] += 1
    return tensors


def all_reduce_grads(mesh: Mesh, params: Iterable[torch.Tensor],
                     shares: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """Sum the gradients of `params` across the ranks, in place, in one
    all-reduce over their flattened concatenation (a missing gradient counts
    as zeros). `shares` ({name: this rank's scalar share of a metric}) ride
    the same all-reduce; returns their sums. GSPMD inserts this psum in the
    JAX package."""
    params = list(params)
    shares = shares or {}
    flat = [p.grad.reshape(-1) if p.grad is not None else torch.zeros(p.numel(), device=p.device, dtype=p.dtype)
            for p in params]
    flat += [torch.as_tensor(v, dtype=torch.float32, device=mesh.device).detach().reshape(1) for v in shares.values()]
    bucket = torch.cat([f.to(mesh.device, torch.float32) for f in flat])
    dist.all_reduce(bucket, op=dist.ReduceOp.SUM, group=mesh.group)
    mesh.calls["all_reduce_grads"] += 1
    offset = 0
    for p in params:
        n = p.numel()
        p.grad = bucket[offset:offset + n].view(p.shape).to(p.device, p.dtype)
        offset += n
    return {name: bucket[offset + i] for i, name in enumerate(shares)}


class _GatherAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, size):
        ctx.mesh, ctx.axis = mesh, axis
        width = -(-size // mesh.size)  # the largest share
        pad = list(x.shape)
        pad[axis] = width - x.shape[axis]
        padded = torch.cat([x, x.new_zeros(pad)], dim=axis).contiguous()
        parts = [torch.empty_like(padded) for _ in range(mesh.size)]
        dist.all_gather(parts, padded, group=mesh.group)
        mesh.calls["gather_axis"] += 1
        q, r = divmod(size, mesh.size)
        return torch.cat([p.narrow(axis, 0, q + (1 if i < r else 0)) for i, p in enumerate(parts)], dim=axis)

    @staticmethod
    def backward(ctx, grad):
        # every rank holds the same gradient of the gathered tensor (the work
        # after the gather is replicated): this rank's slice, no reduction
        return shard_axis(ctx.mesh, grad, ctx.axis).contiguous(), None, None, None


def gather_axis(mesh: Mesh, x: torch.Tensor, axis: int, size: Optional[int] = None) -> torch.Tensor:
    """All ranks' shares of a tensor along `axis`, concatenated in rank order
    (`size` is the whole length; without it the ranks exchange their
    lengths first). Differentiable: the backward returns only this rank's
    slice of the incoming gradient, with no reduction, because every rank
    computes the same gradient downstream. (`torch.distributed.nn`'s
    all_gather reduce-scatters with SUM instead, which would count the
    gradient once per rank.) GSPMD inserts this gather in the JAX package."""
    if size is None:
        n = torch.tensor([x.shape[axis]], device=mesh.device)
        dist.all_reduce(n, group=mesh.group)
        size = int(n)
    return _GatherAxis.apply(x, mesh, axis, size)


def params_of(optimizers: Sequence[torch.optim.Optimizer]):
    """Every parameter of the optimizers, in order."""
    return [p for opt in optimizers for group in opt.param_groups for p in group["params"]]
