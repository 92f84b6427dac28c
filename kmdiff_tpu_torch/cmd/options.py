"""Typed option bags + the resume manifest.

Reference: include/kmdiff/cmd/count_opt.hpp, diff_opt.hpp:6-133. The binary
options.bin dump becomes a JSON manifest (options.json) holding the same
fields; compare_options reproduces the redo bitmask semantics
(diff_opt.hpp:106-133): bit0 = re-merge, bit1 = re-popstrat, bit2 =
re-correct.
"""

from __future__ import annotations

import dataclasses
import json

from kmdiff_tpu_torch.core.corrector import (
    CorrectionType,
    correction_type_from_str,
    correction_type_str,
)

REDO_MERGE = 0b1
REDO_POP = 0b10
REDO_CORRECT = 0b100


@dataclasses.dataclass
class CountOptions:
    fof: str = ""
    directory: str = "./km_dir"
    kmer_size: int = 31
    hard_min: int = 1
    minimizer_type: int = 0
    minimizer_size: int = 10
    repartition_type: int = 0
    nb_partitions: int = 4
    nb_threads: int = 4
    #: device budget (--devices): the port runs on one device and refuses
    #: more (ROADMAP.md port queue item 7: multi-GPU)
    n_devices: int = 0


@dataclasses.dataclass
class DiffOptions:
    kmtricks_dir: str = ""
    output_directory: str = "./kmdiff_output"
    nb_controls: int = 0
    nb_cases: int = 0
    threshold: float = 0.05
    cutoff: float = 1e5
    correction: CorrectionType = CorrectionType.BONFERRONI
    in_memory: bool = False
    kff: bool = False
    pop_correction: bool = False
    #: replicate the reference pop_strat_corrector VERBATIM for A/B runs:
    #: forced (buggy) standardize, reference glm_irls, raw likelihood
    #: products with the 0.001/1.0 underflow hack (popstrat.hpp:249-333,
    #: src/popstrat.cpp:325-370). The default path fixes those bugs and
    #: batches the fits on device; this switch exists to compare against
    #: reference-kmdiff outputs.
    compat_popstrat: bool = False
    kmer_pca: float = 0.001
    ploidy: int = 2
    is_diploid: bool = True
    npc: int = 2
    covariates: str = ""
    gender: str = ""
    learning_rate: float = 0.1
    #: None = "not explicitly set": the default path resolves to 500 / 1e-7
    #: and --compat-popstrat to the reference defaults 100 / 1e-30
    #: (popstrat.hpp:168-176 only overrides on an explicit flag)
    max_iteration: int | None = None
    epsilon: float | None = None
    stand: bool = False
    irls: bool = True
    keep_tmp: bool = False
    seed: int = 0
    log_size: int = 10000
    total_kmers: int = 0
    save_sk: bool = False
    nb_threads: int = 4
    model_lib_path: str = ""
    model_config: str = ""
    #: device budget (see CountOptions.n_devices)
    n_devices: int = 0


_MANIFEST_FIELDS = (
    "threshold", "cutoff", "pop_correction", "kmer_pca", "npc", "total_kmers",
    "compat_popstrat",
)


def dump_options(opt: DiffOptions, path: str) -> None:
    data = {f: getattr(opt, f) for f in _MANIFEST_FIELDS}
    data["correction"] = correction_type_str(opt.correction)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def load_options(path: str) -> DiffOptions:
    with open(path) as f:
        data = json.load(f)
    opt = DiffOptions()
    for f_ in _MANIFEST_FIELDS:
        if f_ in data:
            setattr(opt, f_, data[f_])
    opt.correction = correction_type_from_str(data.get("correction", "bonferroni"))
    return opt


def compare_options(opt: DiffOptions, prev: DiffOptions) -> int:
    """Redo bitmask (reference: diff_opt.hpp:106-133)."""
    r = 0
    if opt.threshold != prev.threshold or opt.cutoff != prev.cutoff:
        r |= REDO_MERGE
    if prev.pop_correction and opt.pop_correction:
        if opt.kmer_pca != prev.kmer_pca:
            r |= REDO_MERGE | REDO_POP
        if opt.npc != prev.npc:
            r |= REDO_POP
        if opt.compat_popstrat != prev.compat_popstrat:
            r |= REDO_POP
    if not prev.pop_correction and opt.pop_correction:
        r |= REDO_MERGE | REDO_POP
    if opt.correction != prev.correction:
        r |= REDO_CORRECT
    if prev.pop_correction and not opt.pop_correction:
        r |= REDO_CORRECT
    return r
