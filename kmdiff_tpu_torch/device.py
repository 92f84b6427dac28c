"""The device every entry point of the port runs on.

The device is always explicit: each library entry takes ``device`` and the
CLI's ``main`` takes it too (``"cuda"`` by default). A CUDA device that is
not there is an error at once; nothing falls back to the CPU. On the CPU
every kernel wrapper runs its plain PyTorch twin, which is how the tests
run the port.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available "
                "(pass device='cpu' to run the plain PyTorch twins)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cpu or cuda)")
    return dev
