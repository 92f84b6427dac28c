"""Cohort simulator: generate a controls/cases read-set population with
planted variants.

The reference declares a `popsim` command but never builds it (vestigial:
include/kmdiff/cmd/popsim.hpp references non-existent simulator headers,
src/main.cc:86-91 is #ifdef'd out). kmdiff-tpu (and this copy of its
simulator in the port) implements the intent as a
working feature: simulate a reference genome (or load one), plant
case-associated and control-associated variants (insertions/deletions of
SV-length material), sample per-individual variant subsets, and shred
everything into error-bearing reads — producing a fof + FASTA set that
`count` + `diff` can analyze end-to-end with known ground truth.

All randomness is a seeded numpy Generator: cohorts are reproducible.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclasses.dataclass
class SimOptions:
    output_directory: str = "./popsim_out"
    reference: str = ""  # FASTA path; synthesized when empty
    genome_len: int = 100_000
    nb_controls: int = 5
    nb_cases: int = 5
    mean_sv_len: int = 500
    sd_sv_len: int = 50
    nb_sv_controls: int = 5  # variants private to the control pool
    nb_sv_cases: int = 5  # variants private to the case pool
    prob_case: float = 0.1  # leak: case variant appearing in a control
    prob_control: float = 0.1  # leak: control variant in a case
    sv_per_indiv: float = 0.8  # carrier probability per individual/variant
    read_size: int = 100
    coverage: int = 10
    error_rate: float = 0.001
    kmer_size: int = 31
    seed: int = 42


def _random_genome(rng, n: int) -> np.ndarray:
    return _BASES[rng.integers(0, 4, n)]


def _load_or_make_reference(opt: SimOptions, rng) -> np.ndarray:
    if opt.reference:
        from kmdiff_tpu_torch.io.fasta import read_sequences

        seqs = read_sequences(opt.reference)
        return np.frombuffer(b"".join(seqs), dtype=np.uint8).copy()
    return _random_genome(rng, opt.genome_len)


def _make_variants(rng, genome_len: int, n: int, mean_len: int, sd_len: int):
    """Each variant: an insertion of novel sequence at a random locus."""
    out = []
    for _ in range(n):
        length = max(50, int(rng.normal(mean_len, sd_len)))
        pos = int(rng.integers(0, genome_len))
        out.append((pos, _random_genome(rng, length)))
    return out


def _individual_genome(genome: np.ndarray, variants, carried: np.ndarray):
    """Apply carried insertions (sorted by locus, applied back to front)."""
    g = genome
    for (pos, seq), take in sorted(
        zip(variants, carried), key=lambda t: -t[0][0]
    ):
        if take:
            g = np.concatenate([g[:pos], seq, g[pos:]])
    return g


def _shred(rng, genome: np.ndarray, read_size: int, coverage: int,
           error_rate: float):
    n_reads = max(1, (len(genome) * coverage) // read_size)
    starts = rng.integers(0, max(1, len(genome) - read_size), n_reads)
    reads = np.empty((n_reads, read_size), dtype=np.uint8)
    for i, s in enumerate(starts):
        reads[i] = genome[s : s + read_size]
    # sequencing errors: substitute random bases
    errs = rng.random(reads.shape) < error_rate
    reads[errs] = _BASES[rng.integers(0, 4, int(errs.sum()))]
    return reads


def simulate(opt: SimOptions) -> dict:
    """Run the simulation; writes per-sample FASTAs + fof.txt + truth files.

    Returns a summary dict (paths + planted-variant truth)."""
    rng = np.random.default_rng(opt.seed)
    os.makedirs(opt.output_directory, exist_ok=True)

    genome = _load_or_make_reference(opt, rng)
    v_controls = _make_variants(
        rng, len(genome), opt.nb_sv_controls, opt.mean_sv_len, opt.sd_sv_len
    )
    v_cases = _make_variants(
        rng, len(genome), opt.nb_sv_cases, opt.mean_sv_len, opt.sd_sv_len
    )

    fof_lines = []
    n_total = opt.nb_controls + opt.nb_cases
    for i in range(n_total):
        is_case = i >= opt.nb_controls
        sid = f"{'case' if is_case else 'control'}_{i}"
        # carrier draws: own-pool variants at sv_per_indiv, leaked
        # cross-pool variants at prob_case/prob_control
        own = v_cases if is_case else v_controls
        other = v_controls if is_case else v_cases
        leak = opt.prob_control if is_case else opt.prob_case
        carried_own = rng.random(len(own)) < opt.sv_per_indiv
        carried_other = rng.random(len(other)) < leak
        g = _individual_genome(genome, own, carried_own)
        g = _individual_genome(g, other, carried_other)
        reads = _shred(rng, g, opt.read_size, opt.coverage, opt.error_rate)
        # absolute path: fof entries resolve relative to the fof's own
        # directory downstream (io.kmtricks semantics)
        path = os.path.abspath(
            os.path.join(opt.output_directory, f"{sid}.fasta")
        )
        with open(path, "wb") as f:
            for j, r in enumerate(reads):
                f.write(b">r%d\n" % j)
                f.write(r.tobytes())
                f.write(b"\n")
        fof_lines.append(f"{sid} : {path}")

    fof_path = os.path.join(opt.output_directory, "fof.txt")
    with open(fof_path, "w") as f:
        f.write("\n".join(fof_lines) + "\n")

    # ground truth: the planted variant sequences as FASTA
    truth_path = os.path.join(opt.output_directory, "truth.fasta")
    with open(truth_path, "wb") as f:
        for label, variants in (("control", v_controls), ("case", v_cases)):
            for i, (pos, seq) in enumerate(variants):
                f.write(b">%s_sv%d_pos%d\n" % (label.encode(), i, pos))
                f.write(seq.tobytes())
                f.write(b"\n")

    return {
        "fof": fof_path,
        "truth": truth_path,
        "nb_controls": opt.nb_controls,
        "nb_cases": opt.nb_cases,
        "genome_len": int(len(genome)),
        "nb_sv_controls": len(v_controls),
        "nb_sv_cases": len(v_cases),
    }
