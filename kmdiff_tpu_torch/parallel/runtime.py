"""The process's mesh (port of kmdiff_tpu/parallel/runtime.py).

  * ``configure(n_devices)``: called by the commands from ``--devices``
    (0, the default, means every card from the command's device on, or one
    shard on the CPU); ``configure(None)`` forgets it.
  * ``get_mesh(device)``: the mesh for a command on `device`; a single
    shard on `device` itself when one shard is in play (Mesh.map then
    starts no thread). Without a ``configure`` the KMDIFF_DEVICES variable
    is read, and without either a library caller stays on one device.
  * ``set_virtual(on)``: the library-level switch that makes a CUDA mesh
    repeat the command's device (two shards on cuda:0, say) instead of
    taking distinct cards: the counterpart of the JAX package's
    --xla_force_host_platform_device_count for its tests, set by tests and
    chip_smoke.py. It is never a CLI flag, and nothing falls back to it
    when cards are missing.

Under the multi-process runtime (parallel.distributed) each rank runs on
its one card: ``--devices 0`` means that card, and more than one shard is
ROADMAP.md port-queue item 7c.
"""

from __future__ import annotations

import os
import threading

import torch

from kmdiff_tpu_torch.parallel.mesh import Mesh, make_mesh
from kmdiff_tpu_torch.utils.logging import logger

_lock = threading.Lock()
_requested: int | None = None
_virtual = False
_meshes: dict = {}


def configure(n_devices: int | None) -> None:
    """Set the shard budget of the commands that follow: n_devices shards,
    0 for every card, None to forget the setting."""
    global _requested
    with _lock:
        _requested = n_devices
        _meshes.clear()


def set_virtual(on: bool) -> None:
    """Make CUDA meshes repeat the command's device (on) or take distinct
    cards (off, the default)."""
    global _virtual
    with _lock:
        _virtual = bool(on)
        _meshes.clear()


def mesh_under_distributed(n: int) -> NotImplementedError:
    return NotImplementedError(
        f"--devices {n} under --distributed is not ported to kmdiff_tpu_torch "
        "yet (ROADMAP.md port queue item 7c: the mesh under --distributed)")


def get_mesh(device: torch.device) -> Mesh:
    """The mesh of a command on `device`, built once a configuration;
    Mesh((device,)) for one shard."""
    from kmdiff_tpu_torch.parallel.distributed import is_distributed

    n = _requested
    env = os.environ.get("KMDIFF_DEVICES")
    if n is None and env:
        n = int(env)
    if n is not None and n > 1 and is_distributed():
        raise mesh_under_distributed(n)
    if n == 0 and not is_distributed():
        n = (torch.cuda.device_count() - (device.index or 0)
             if device.type == "cuda" else 1)
    if n is None or n <= 1:
        return Mesh((device,))
    with _lock:
        key = (n, device, _virtual)
        mesh = _meshes.get(key)
        if mesh is None:
            mesh = _meshes[key] = make_mesh(n, device, _virtual)
            logger.info("mesh: %d shards on %s", n,
                        ", ".join(str(d) for d in mesh.devices))
    return mesh
