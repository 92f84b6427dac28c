"""The cohort is deterministic in the seed and holds the configuration's
sizes."""

import hashlib

import numpy as np
import torch

from kbench import cohort, reference
from kbench.tests.helpers import tiny_config


def _digest(co):
    h = hashlib.sha1()
    for p in co.paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def test_same_seed_same_files_other_seed_other_files(tmp_path):
    cfg = tiny_config()
    a = cohort.make(cfg, 2**31 + 5, str(tmp_path / "a"), threads=3)
    b = cohort.make(cfg, 2**31 + 5, str(tmp_path / "b"), threads=1)
    c = cohort.make(cfg, 2**31 + 6, str(tmp_path / "c"))
    assert _digest(a) == _digest(b) != _digest(c)


def test_sizes_match_the_config(tmp_path):
    from kmdiff_tpu_torch.io.fasta import flat_codes
    from kmdiff_tpu_torch.io.kmtricks import Fof

    cfg = tiny_config()
    co = cohort.make(cfg, 11, str(tmp_path))
    n = cfg["genome_len"] * cfg["coverage"] // cfg["read_size"]
    assert co.n_reads == n and len(co.paths) == cfg["nb_controls"] + cfg["nb_cases"]
    assert [e.id for e in Fof.parse(co.fof).entries] == co.ids
    assert co.ids[:cfg["nb_controls"]] == [f"control_{i}" for i in range(cfg["nb_controls"])]
    total = 0
    for i, p in enumerate(co.paths):
        r = cohort.reads(co, i)
        assert r.shape == (n, cfg["read_size"])
        assert set(np.unique(r)) <= set(b"ACGT")
        total += len(flat_codes(p))
    assert total == co.codes


def _case_only_kmers(cfg, tmp, seed) -> int:
    co = cohort.make(cfg, seed, tmp)
    counts = reference.count_cohort(co, cfg["kmer_size"], 1, torch.device("cpu"))
    return int(((counts.s_c == 0) & (counts.s_k >= 20)).sum())


def test_variants_are_planted(tmp_path):
    """A case variant carried by every case: its ~430 k-mers are in every
    case and no control; without it no k-mer is."""
    cfg = tiny_config()
    cfg.update(nb_sv_controls=0, nb_sv_cases=1, sd_sv_len=0, mean_sv_len=400,
               sv_per_indiv=1.0, prob_case=0.0)
    assert _case_only_kmers(cfg, str(tmp_path / "a"), 3) >= 300
    cfg.update(nb_sv_cases=0)
    assert _case_only_kmers(cfg, str(tmp_path / "b"), 3) == 0
