"""`infos`: build and runtime metadata of the port (reference:
include/kmdiff/cmd/infos.hpp:32-64; port of kmdiff_tpu/cmd/infos.py, with
torch, the card and the port's two libraries in place of JAX's device
list). Builds nothing."""

from __future__ import annotations

import os
import platform
import sys

import numpy
import torch

from kmdiff_tpu_torch import __version__, kernels, native


def _built(path: str) -> str:
    return f"{path} ({'built' if os.path.exists(path) else 'not built'})"


def main_infos(device: torch.device) -> str:
    if device.type == "cuda":
        major, minor = torch.cuda.get_device_capability(device)
        dev = (f"{device} {torch.cuda.get_device_name(device)}, compute "
               f"capability {major}.{minor}")
    elif torch.cuda.is_available():
        dev = f"cpu (cuda: {torch.cuda.device_count()} device(s) not used)"
    else:
        dev = "cpu (cuda: not available)"
    lines = [
        f"kmdiff-tpu-torch {__version__}",
        "",
        f"python     : {sys.version.split()[0]}",
        f"platform   : {platform.platform()}",
        f"torch      : {torch.__version__} (CUDA {torch.version.cuda or 'none'})",
        f"numpy      : {numpy.__version__}",
        f"device     : {dev}",
        f"kernels    : {_built(kernels.library_path())}",
        f"native lib : {_built(native.library_path())}",
        "",
        "features   : count, diff, run (k 8-128), popstrat, --save-sk,",
        "             model plugins (process_block_torch, process_block,",
        "             process), call, popsim, warmup, FASTA + KFF output,",
        "             resume, --distributed (ranks of a gloo process group),",
        "             --devices N (a mesh of N shards in one process; under",
        "             --distributed a mesh of N cards a rank, --devices 0",
        "             there one card a rank), --profile DIR (torch.profiler",
        "             Chrome traces, one a rank)",
        "not ported : KMDIFF_GROUP_MERGE (ROADMAP port queue item 1: run",
        "             ignores it)",
    ]
    return "\n".join(lines)
