"""The shard mesh (port of kmdiff_tpu/parallel/mesh.py).

The JAX package's mesh is one jax.sharding.Mesh axis, "rows", over the
local devices. Here a Mesh is an ordered list of torch devices, one a
shard, and a shard's work runs on a worker thread of its own under its
device (``Mesh.map``), so that shards on distinct cards overlap. Shard d
owns key range d of a merge chunk and the partitions with part % D == d in
the counting shuffle; results come back in shard order, which is ascending
key-range order.

On the CPU every shard is the CPU (the tests' meshes, as the JAX tests run
on eight virtual CPU devices). On CUDA a mesh of N shards takes N distinct
cards from the command's device on, or, as a virtual mesh
(``parallel.runtime``'s switch), repeats one card N times.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import dataclasses

import torch

from kmdiff_tpu_torch import profiling


@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct(self) -> list[torch.device]:
        """The mesh's devices, each once, in shard order."""
        return list(dict.fromkeys(self.devices))

    def blocks(self, n_rows: int) -> list[tuple[int, int]]:
        """n_rows rows cut into contiguous (start, end) blocks in order, one
        a shard and none empty (a single empty block for no rows)."""
        n = max(1, min(self.size, n_rows))
        return [(d * n_rows // n, (d + 1) * n_rows // n) for d in range(n)]

    def map(self, fn, n: int | None = None) -> list:
        """fn(d, device) for shards d < n (every shard by default), each on
        a thread of its own under its device; the results in shard order.
        The first shard's exception is raised once every shard ended. Under
        --profile each shard's call is a ``kmd:shard<d>`` range."""
        n = self.size if n is None else n

        def one(d: int):
            dev = self.devices[d]
            ctx = (torch.cuda.device(dev) if dev.type == "cuda"
                   else contextlib.nullcontext())
            with ctx, profiling.span(f"kmd:shard{d}", timed=False):
                return fn(d, dev)

        if n <= 1:
            return [one(d) for d in range(n)]
        with cf.ThreadPoolExecutor(n, thread_name_prefix="kmdiff-shard") as pool:
            futures = [pool.submit(one, d) for d in range(n)]
            cf.wait(futures)
        return [f.result() for f in futures]


def make_mesh(n_devices: int, device: torch.device,
              virtual: bool = False) -> Mesh:
    """A mesh of n_devices shards for a command on `device`: the CPU n
    times; on CUDA n distinct cards from device's index on (ValueError with
    fewer), or with virtual `device` n times."""
    if n_devices < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_devices}")
    if device.type != "cuda" or virtual:
        return Mesh((device,) * n_devices)
    first = device.index or 0
    have = torch.cuda.device_count() - first
    if have < n_devices:
        raise ValueError(
            f"need {n_devices} CUDA devices from {device}, have {have} "
            "(a virtual mesh on one card is parallel.runtime.set_virtual)")
    return Mesh(tuple(torch.device("cuda", first + i) for i in range(n_devices)))
