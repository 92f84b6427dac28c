"""The multi-process runtime (port of kmdiff_tpu/parallel/distributed.py).

Every rank runs the same command over a shared filesystem and the
single-device path on its own device:

  * rank r of W counts samples r, r + W, ... (``owned_samples``) into the
    shared run directory, and merges and corrects partitions r, r + W, ...
    (``owned_partitions``);
  * the primary (rank 0) copies the fof, fits PCA and the null model once,
    and aggregates and writes the output;
  * between ranks go only named barriers at the filesystem hand-offs, the
    four counters of the merge (``global_sum``) and the primary's resume
    decision (``from_primary``). Every bulk byte goes through the files,
    as in the JAX package, whose protocol moves no device array either
    (``multihost_utils.sync_global_devices`` and ``process_allgather``).

The process group runs on **gloo**, on the host: it carries nothing but
small CPU tensors, and NCCL refuses two ranks on one GPU, which is how one
card runs two ranks. Each rank's device is ``rank_device``: a CUDA request
takes the first of the rank's cards (``rank_cards``: ``cuda:(rank mod
device count)`` for one shard a rank, the N cards from ``cuda:(rank N mod
device count)`` on for a mesh of N shards, ``--devices N``), a CPU request
stays on the CPU. Every rank checks every rank's cards before the command
runs, so a machine with too few cards fails on all ranks at once.

The group is opened with an explicit timeout (``init_distributed``,
``KMDIFF_DIST_TIMEOUT`` seconds, default ``DEFAULT_TIMEOUT``): a rank that
died makes the others fail at their next collective instead of hanging.
A group lives for one command: cli.main opens it and, after a last
barrier, closes it, so the ranks leave a command together. Commands run
one after the other within one process need a port each: a rank could
otherwise reach the previous command's coordinator in the primary in the
moment before the primary closes it.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from kmdiff_tpu_torch.utils.logging import logger

#: seconds a collective waits for the other ranks (a barrier waits for the
#: slowest rank's share of a stage)
DEFAULT_TIMEOUT = 1800.0


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     timeout: float | None = None) -> bool:
    """Open the process group from the arguments or from KMDIFF_COORDINATOR
    (HOST:PORT, rank 0 listens there), KMDIFF_NUM_PROCESSES and
    KMDIFF_PROCESS_ID. Returns True when a group of more than one process
    is open; False, opening nothing, without a coordinator or with one
    process."""
    coordinator = coordinator or os.environ.get("KMDIFF_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("KMDIFF_NUM_PROCESSES", "0") or 0)
    if process_id is None:
        pid_env = os.environ.get("KMDIFF_PROCESS_ID")
        process_id = int(pid_env) if pid_env is not None else None
    if not coordinator or not num_processes or num_processes <= 1:
        return False
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id must be in [0, {num_processes}), got "
                         f"{process_id}")
    if timeout is None:
        timeout = float(os.environ.get("KMDIFF_DIST_TIMEOUT", DEFAULT_TIMEOUT))
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout),
    )
    logger.info("distributed runtime: process %d/%d (gloo, %s, timeout %.0f s)",
                process_id, num_processes, coordinator, timeout)
    return True


def shutdown() -> None:
    """Close the process group, if one is open (the primary's coordinator
    port with it)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_distributed() -> bool:
    return world_size() > 1


def is_primary() -> bool:
    return rank() == 0


def owned_samples(n_samples: int) -> list[int]:
    """Sample indices this rank counts (round-robin by rank)."""
    return list(range(rank(), n_samples, world_size()))


def owned_partitions(n_partitions: int) -> list[int]:
    """Partition indices this rank merges and corrects."""
    return list(range(rank(), n_partitions, world_size()))


def rank_cards(r: int, shards: int, cards: int,
               virtual: bool = False) -> list[int]:
    """The card indices of rank r's mesh of `shards` shards on a machine of
    `cards` cards: cuda:(r mod cards) for one shard (0 or 1) or a virtual
    mesh (the card repeated), else the `shards` cards from cuda:(r shards
    mod cards) on. ValueError when they run past the last card."""
    width = 1 if virtual or shards <= 1 else shards
    first = r * width % cards
    if first + width > cards:
        raise ValueError(
            f"--devices {shards} under --distributed: rank {r} needs cuda:"
            f"{first}-{first + width - 1}, the machine has {cards} CUDA "
            "device(s) (a virtual mesh on one card is "
            "parallel.runtime.set_virtual)")
    return list(range(first, first + width))


def rank_device(device: torch.device, shards: int = 1) -> torch.device:
    """This rank's device for a requested one and its shard budget
    (--devices): the first of its cards (rank_cards), made the current
    device, for a CUDA request, after checking every rank's cards; the CPU
    stays."""
    if device.type != "cuda":
        return device
    from kmdiff_tpu_torch.parallel.runtime import is_virtual

    cards, virtual = torch.cuda.device_count(), is_virtual()
    for r in range(world_size()):
        rank_cards(r, shards, cards, virtual)
    dev = torch.device("cuda", rank_cards(rank(), shards, cards, virtual)[0])
    torch.cuda.set_device(dev)
    return dev


def barrier(name: str) -> None:
    """Rendezvous of every rank at a filesystem hand-off; no-op in a
    single process."""
    if not is_distributed():
        return
    logger.debug("barrier %s: process %d waits", name, rank())
    dist.barrier()
    logger.debug("barrier %s: passed", name)


def global_sum(values: list[int]) -> list[int]:
    """Element-wise sum of per-rank integer counters over every rank."""
    if not is_distributed():
        return list(values)
    t = torch.tensor(values, dtype=torch.int64)
    dist.all_reduce(t)
    return t.tolist()


def from_primary(value):
    """The primary's value (any picklable object) on every rank; a
    rendezvous too. A decision the primary takes from the shared files
    before any rank writes to them is the same on every rank, whenever
    each rank started."""
    if not is_distributed():
        return value
    box = [value if is_primary() else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]
