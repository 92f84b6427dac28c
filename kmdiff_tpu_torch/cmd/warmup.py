"""`warmup`: pay the port's one-time costs before a long run (port of
kmdiff_tpu/cmd/warmup.py).

The JAX warmup fills XLA's compile cache for one cohort shape. The port
compiles no shape, but a fresh checkout's first command pays the nvcc build
of the kernel library (kernels.build: one nvcc a source, K-IRLS alone 18
kernels) and the make build of the native host library, and each kernel's
first launch on a device sets its one-time attributes (K-EXT's multi-word
form, K-GRAM and K-IRLS set their shared-memory limit once a device).
`warmup` builds both libraries when missing, then launches every kernel of
the main path and of popstrat once on the command's device, through the
pipeline's own entry points, on a synthetic cohort of S = nb_controls +
nb_cases samples made in memory (a shared random sequence, and a segment
that only the cases carry, sixteen times), merged at diff's default cut,
at the JAX warmup's sizes without its padding ladder:

  * counting: the two-stage count of one sample at each of count_codes
    codes (K-EXT, K-RUN), the fused run's resident count of each sample
    (K-HIST) and the dedup of a sample counted in two chunks (K-WRUN);
  * one fused-run merge over the S resident streams (K-ASM into the packed
    merge: K-RUN, K-LRT, K-CMP);
  * the two-stage merge + K-LRT at each of merge_rows rows;
  * with pop: the fused merge again with the full merge and geno sampling
    (K-ROWS, K-GENO), the PCA of the sampled rows (K-GRAM) and the null and
    alt fits of its survivors (K-IRLS) at the cohort's S and n_pc.

k > 32 takes the multi-word forms. Logs the build seconds and each group's
seconds; writes no file but the libraries under build/. On the CPU it runs
the kernels' plain twins (the tests pass smaller sizes).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from kmdiff_tpu_torch.utils.logging import logger


class _Sampler:
    """A GenoSampler that keeps the sampled geno rows in memory."""

    rate = 0.05
    seed = 0

    def __init__(self):
        self.geno: list[np.ndarray] = []

    def add_sampled(self, partition: int, presence: np.ndarray) -> None:
        self.geno.append(presence)


def build_libraries(device: torch.device) -> dict:
    """Build what is missing of the kernel library (on a card) and the
    native host library; their seconds, 0.0 for one already built."""
    from kmdiff_tpu_torch import kernels, native

    out = {}
    if device.type == "cuda":
        built = os.path.exists(kernels.library_path())
        t0 = time.perf_counter()
        kernels.lib()
        out["kernels"] = 0.0 if built else time.perf_counter() - t0
    built = os.path.exists(native.library_path())
    t0 = time.perf_counter()
    if not native.available():
        logger.warning("warmup: the native host library did not build")
    out["native"] = 0.0 if built else time.perf_counter() - t0
    return out


def _cohort_codes(S: int, nb_controls: int, n: int, rng) -> list[np.ndarray]:
    """S samples' 2-bit codes: one shared random sequence of n codes; the
    cases also carry a segment of n / 64 codes sixteen times (k-mers that
    pass diff's default cut even at a test's few thousand codes)."""
    base = rng.integers(0, 4, n, dtype=np.uint8)
    extra = np.tile(rng.integers(0, 4, max(n // 64, 64), dtype=np.uint8), 16)
    return [base if s < nb_controls else np.concatenate([base, extra])
            for s in range(S)]


def _merge_inputs(S: int, rows: int, kmer_size: int, rng):
    """S sorted host streams ([U, nw] u64 keys, u32 counts) of about rows
    rows in all, drawn from a pool twice as large."""
    from kmdiff_tpu_torch.core.kmer import n_words

    nw = n_words(kmer_size)
    per = max(rows // S, 2)
    top = 1 << min(2 * kmer_size - 1, 62)
    kmers, counts = [], []
    for _ in range(S):
        col = np.unique(rng.integers(0, min(2 * rows, top), per, dtype=np.uint64))
        kmers.append(np.repeat(col[:, None], nw, axis=1))
        counts.append(rng.integers(1, 16, len(col), dtype=np.uint32))
    return kmers, counts


def main_warmup(nb_controls: int, nb_cases: int, kmer_size: int,
                device: torch.device, pop: bool = False, npc: int = 2,
                count_codes: tuple[int, ...] = (1 << 22, (5 << 21) - 64),
                sample_codes: int = 1 << 20,
                merge_rows: tuple[int, ...] = (1 << 16, 1 << 22)) -> dict:
    """Build the libraries, then launch every kernel of the main path (and
    of popstrat with pop) once on `device`. The sizes are the JAX warmup's
    (kmdiff_tpu/cmd/warmup.py:27-28, :45, :63-68): codes of the two-stage
    counts, codes of each sample of the fused run's cohort, rows of the
    two-stage merges. Returns the seconds of the builds ("kernels",
    "native") and of each group ("count", "run chunk", "merge",
    "popstrat")."""
    from kmdiff_tpu_torch.core.model import PoissonLikelihood
    from kmdiff_tpu_torch.io.accumulator import KmerSignBlock, VectorAccumulator
    from kmdiff_tpu_torch.ops.codec import dedup_sum
    from kmdiff_tpu_torch.pipeline import fused
    from kmdiff_tpu_torch.pipeline.count import count_sample_device
    from kmdiff_tpu_torch.pipeline.merge import PartitionProcessor

    S = nb_controls + nb_cases
    if nb_controls < 1 or nb_cases < 1:
        raise ValueError("warmup needs at least one control and one case")
    seconds = build_libraries(device)
    logger.info("Warmup on %s for S=%d, k=%d: kernel library %.1f s, native "
                "library %.1f s to build (0 when built).", device, S,
                kmer_size, seconds.get("kernels", 0.0), seconds["native"])
    rng = np.random.default_rng(0)

    def timed(name: str, fn) -> None:
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds[name] = time.perf_counter() - t0
        logger.info("  %s: %.3f s", name, seconds[name])

    streams: list = []

    def count() -> None:
        for n in count_codes:
            count_sample_device([rng.integers(0, 4, n, dtype=np.uint8)],
                                kmer_size, 4, device)
        streams.extend(fused.count_sample_resident([c], kmer_size, 1, device)
                       for c in _cohort_codes(S, nb_controls, sample_codes, rng))
        # a sample counted in two chunks: its partial counts dedup-summed
        a, b = streams[0], streams[-1]
        dedup_sum(torch.cat([a.keys, b.keys], -1), torch.cat([a.counts, b.counts]),
                  with_hist=True)

    def processor(**kw) -> PartitionProcessor:
        totals = [s.total_mass for s in streams]
        model = PoissonLikelihood(nb_controls, nb_cases, totals[:nb_controls],
                                  totals[nb_controls:])
        # diff's default cut (-s 0.05 --cutoff 1e5), the JAX warmup's tight
        # one: a looser cut keeps most random rows and the host's f64
        # rescore of them, not the kernels, takes the time
        return PartitionProcessor(model, nb_controls, nb_cases, 0.05 / 1e5,
                                  device, **kw)

    def run_chunk() -> None:
        fused.fused_merge(processor(), [VectorAccumulator() for _ in range(4)],
                          streams, 4, kmer_size)

    def merge() -> None:
        proc = processor()
        for rows in merge_rows:
            kmers, counts = _merge_inputs(S, rows, kmer_size, rng)
            proc._process_device_merge(0, kmers, counts, VectorAccumulator(),
                                       kmer_size)

    def popstrat() -> None:
        from kmdiff_tpu_torch.ops.pca import eigenstrat_pca
        from kmdiff_tpu_torch.pipeline.popstrat import PopStratCorrector

        sampler, accs = _Sampler(), [VectorAccumulator() for _ in range(4)]
        fused.fused_merge(processor(keep_counts=True, sampler=sampler), accs,
                          streams, 4, kmer_size)
        Z, _evals = eigenstrat_pca(np.concatenate(sampler.geno), device)
        totals = [s.total_mass for s in streams]
        corr = PopStratCorrector(nb_controls, nb_cases, totals[:nb_controls],
                                 totals[nb_controls:], npc, device=device)
        corr.set_Z(Z)
        corr.init_global_features()
        blocks = [b for a in accs for b in a.blocks() if len(b)]
        corr.correct_block(KmerSignBlock.concat(blocks))

    t0 = time.perf_counter()
    timed("count", count)
    timed("run chunk", run_chunk)
    timed("merge", merge)
    if pop:
        timed("popstrat", popstrat)
    logger.info("Warmup done in %.3f s (after the builds).",
                time.perf_counter() - t0)
    return seconds
