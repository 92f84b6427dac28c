"""`count`: build a kmtricks-compatible counting run directory from read
sets (port of kmdiff_tpu/cmd/count.py)."""

from __future__ import annotations

import os

import torch

from kmdiff_tpu_torch.cmd.options import CountOptions
from kmdiff_tpu_torch.parallel import runtime
from kmdiff_tpu_torch.parallel.distributed import barrier, is_primary
from kmdiff_tpu_torch.utils.logging import logger
from kmdiff_tpu_torch.utils.timer import Timer
from kmdiff_tpu_torch.pipeline.count import run_count


def main_count(opt: CountOptions, device: torch.device) -> None:
    """The `count` command. Under the multi-process runtime only the
    primary writes kmdiff-count.opt, once every rank has counted, and no
    rank returns before the file is there (barrier "count_complete"). The
    shard budget (--devices) configures the mesh runtime
    (parallel.runtime)."""
    runtime.configure(opt.n_devices)
    timer = Timer()
    run_count(opt, device)
    if is_primary():
        # consumed later by read_config (reference: src/cmd.cpp:46-47)
        with open(os.path.join(opt.directory, "kmdiff-count.opt"), "w") as f:
            f.write(f"kmer_size={opt.kmer_size}, abundance_min={opt.hard_min}\n")
    barrier("count_complete")
    logger.info("Done in %s.", timer.formatted())
