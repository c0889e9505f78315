"""Process-group set-up for multi-device runs (counterpart of
voxe_tpu/parallel/distributed.py).

The JAX package runs one program per host over every local device; the port
runs one process per device. A process finds its place from torchrun's
RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT, or, when those
are absent, from the JAX package's JAX_COORDINATOR_ADDRESS ("host:port"),
JAX_NUM_PROCESSES and JAX_PROCESS_ID, so one launch script serves both
packages. The backend is NCCL on CUDA devices and gloo only when the caller
asks for the CPU.

Only the process with local rank 0 writes files and logs: one writer per
host, as the JAX program is one process per host (`is_local_writer`).
`launch_local` starts N local ranks of an entry point on one host; the
CLIs call `spawn_cli_ranks` and `init_cli_group`.
"""
from __future__ import annotations

import logging
import os
import socket
import sys
from datetime import timedelta
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from voxe_tpu_torch.utils.logging import log


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def maybe_init_distributed(
    multihost: bool = False,
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: str = "cuda",
    timeout_s: float = 600.0,
) -> bool:
    """Join the default process group when multi-process execution is
    requested. A no-op that returns False for the default single-process
    run; safe to call more than once.

    The coordinator, world size and rank come from the arguments, else from
    torchrun's variables, else from the JAX_* variables. `device` "cpu"
    selects gloo; any CUDA device selects NCCL, with this process on CUDA
    device LOCAL_RANK. Collectives fail after `timeout_s`."""
    if not multihost:
        return False
    if dist.is_initialized():
        return True
    if coordinator_address is None:
        if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
            coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        else:
            coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    num_processes = num_processes if num_processes is not None else _env_int("WORLD_SIZE", "JAX_NUM_PROCESSES")
    process_id = process_id if process_id is not None else _env_int("RANK", "JAX_PROCESS_ID")
    if coordinator_address is None or num_processes is None or process_id is None:
        raise RuntimeError(
            "multi-process run: set RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT (torchrun does), or "
            "JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and JAX_PROCESS_ID"
        )
    on_cuda = str(device).startswith("cuda")
    if on_cuda:
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {device}: NCCL needs a CUDA device (pass --device cpu for gloo)")
        torch.cuda.set_device(local_rank())
    dist.init_process_group(
        "nccl" if on_cuda else "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, timeout=timedelta(seconds=timeout_s),
    )
    if not is_local_writer():
        log.setLevel(logging.WARNING)  # one log per host, as the JAX program writes it
    log.info(f"torch.distributed initialized: process {dist.get_rank()}/{dist.get_world_size()} "
             f"({dist.get_backend()}), local rank {local_rank()}")
    return True


def local_rank() -> int:
    """This process's rank on its host (LOCAL_RANK; 0 when unset)."""
    return _env_int("LOCAL_RANK") or 0


def is_primary_host() -> bool:
    """True on the process of global rank 0 (on every process of a
    single-process run)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def is_local_writer() -> bool:
    """True on the process that writes this host's files and logs: local
    rank 0, or the only process."""
    return not dist.is_initialized() or local_rank() == 0


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _local_rank_main(rank: int, fn: Callable, args: tuple, world: int, port: int) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    if not logging.getLogger().handlers:  # a spawned rank has no handler of the entry point's
        logging.basicConfig(stream=sys.stdout, level=logging.INFO,
                            format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    fn(*args)


def launch_local(fn: Callable, args: Sequence, num_devices: int) -> None:
    """Run fn(*args) in `num_devices` new local processes (spawned), ranks
    0..N-1 of one group on a free port, each with torchrun's variables set;
    `fn` joins the group through `maybe_init_distributed(True)`. Returns when
    all have ended; raises if one failed."""
    import torch.multiprocessing as mp

    mp.spawn(_local_rank_main, args=(fn, tuple(args), num_devices, free_port()), nprocs=num_devices, join=True)


def launched() -> bool:
    """True in a process that a launcher (torchrun, `launch_local`) started
    as one rank of a group."""
    return bool(os.environ.get("RANK")) and bool(os.environ.get("WORLD_SIZE"))


def spawn_cli_ranks(entry: Callable, argv: Optional[Sequence[str]], config) -> bool:
    """The CLIs' single-command multi-device launch: with
    `config.num_devices > 1`, no launched group and no `--multihost`, run
    `entry(argv)` in that many local ranks and return True once they have
    ended; otherwise return False (this process is the run, or one rank of
    it). A CUDA run that asks for more devices than the host has fails at
    once."""
    if config.num_devices <= 1 or config.multihost or launched():
        return False
    if str(config.device).startswith("cuda"):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < config.num_devices:
            raise ValueError(f"--num_devices {config.num_devices} on --device {config.device}: "
                             f"this host has {have} CUDA device(s)")
    launch_local(entry, (list(sys.argv[1:] if argv is None else argv),), config.num_devices)
    return True


def init_cli_group(config) -> None:
    """Join the group of a launched rank (torchrun, `launch_local`) or of
    `--multihost True`, whose world size must be `config.num_devices`, and
    move `config.device` "cuda" to this rank's card. A no-op for a
    single-process run."""
    if not (config.multihost or launched()):
        return
    maybe_init_distributed(True, device=config.device)
    world = dist.get_world_size()
    if config.num_devices != world:
        raise ValueError(f"--num_devices {config.num_devices}, but the process group holds {world} processes")
    if config.device == "cuda":
        config.device = f"cuda:{local_rank()}"


def barrier() -> None:
    """Wait for every rank of the default group (a no-op without one)."""
    if dist.is_initialized():
        dist.barrier()
