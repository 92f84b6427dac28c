"""`call`: map significant k-mers back to a reference genome (port of
kmdiff_tpu/pipeline/call.py; host-only numpy, as there).

The reference declares this command but ships it disabled
(include/kmdiff/cmd/call.hpp options struct; main_call commented out at
src/main.cc:82-85). kmdiff-tpu implements the intent: exact-match each
significant k-mer (canonical) against a reference FASTA and report every
hit locus + strand, TSV out.

Index: all reference k-mers canonicalized and sorted (vectorized host
codec); queries resolve by binary search — O((G + Q) log G) total, no
per-base scanning.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from kmdiff_tpu_torch.core.kmer import (
    canonical_packed,
    kmers_from_codes,
    revcomp_packed,
    seq_to_codes,
)
from kmdiff_tpu_torch.io.fasta import iter_records
from kmdiff_tpu_torch.utils.logging import logger


@dataclasses.dataclass
class CallOptions:
    kmer_file: str = ""  # control_kmers.fasta / case_kmers.fasta / .kff
    reference: str = ""  # genome FASTA
    output: str = "calls.tsv"
    kmer_size: int = 0  # inferred from the first query when 0


def _load_queries(path: str, k_hint: int) -> tuple[list[str], np.ndarray, int]:
    names, seqs = [], []
    if path.endswith(".kff"):
        from kmdiff_tpu_torch.io.kff import KffReader

        with KffReader(path) as r:
            for i, s in enumerate(r.kmers()):
                names.append(str(i))
                seqs.append(s)
    else:
        for name, seq in iter_records(path):
            names.append(name)
            seqs.append(seq)
    if not seqs:
        return [], np.zeros((0, 1), np.uint64), k_hint or 0
    k = k_hint or len(seqs[0])
    packed = []
    for s in seqs:
        codes, valid = seq_to_codes(s)
        if len(s) != k or not valid.all():
            raise ValueError(f"query {s!r} is not a valid {k}-mer")
        packed.append(kmers_from_codes(codes, valid, k)[0])
    return names, np.stack(packed), k


def main_call(opt: CallOptions) -> dict:
    names, queries, k = _load_queries(opt.kmer_file, opt.kmer_size)
    if not len(names):
        open(opt.output, "w").close()
        return {"queries": 0, "mapped": 0, "hits": 0}

    # reference index: canonical k-mer -> positions, per contig
    contig_names: list[str] = []
    all_kmers, all_pos, all_contig = [], [], []
    for ci, (cname, seq) in enumerate(iter_records(opt.reference)):
        contig_names.append(cname.split()[0])
        codes, valid = seq_to_codes(seq)
        win_ok = np.lib.stride_tricks.sliding_window_view(valid, k).all(axis=1) \
            if len(codes) >= k else np.zeros(0, bool)
        kms = kmers_from_codes(codes, valid, k)
        pos = np.nonzero(win_ok)[0]
        assert len(kms) == len(pos)
        all_kmers.append(canonical_packed(kms, k))
        all_pos.append(pos.astype(np.int64))
        all_contig.append(np.full(len(pos), ci, dtype=np.int32))

    ref_k = np.concatenate(all_kmers) if all_kmers else np.zeros((0, 1), np.uint64)
    ref_pos = np.concatenate(all_pos) if all_pos else np.zeros(0, np.int64)
    ref_ci = np.concatenate(all_contig) if all_contig else np.zeros(0, np.int32)

    nw = ref_k.shape[1]
    if nw == 1:
        order = np.argsort(ref_k[:, 0], kind="stable")
        sorted_keys = ref_k[order, 0]

        canon_q = canonical_packed(queries, k)
        lo = np.searchsorted(sorted_keys, canon_q[:, 0], side="left")
        hi = np.searchsorted(sorted_keys, canon_q[:, 0], side="right")
    else:
        def keybytes(a):
            return np.ascontiguousarray(a.astype(">u8")).reshape(len(a), -1)

        kb = keybytes(ref_k)
        flat = kb.view(f"V{nw * 8}").ravel()
        order = np.argsort(flat, kind="stable")
        sorted_keys = flat[order]
        canon_q = canonical_packed(queries, k)
        qb = keybytes(canon_q).view(f"V{nw * 8}").ravel()
        lo = np.searchsorted(sorted_keys, qb, side="left")
        hi = np.searchsorted(sorted_keys, qb, side="right")

    # strand: '+' when the query as-given equals the reference-forward
    # orientation at that locus is unknowable from the canonical index
    # alone, so report the query-vs-canonical relationship
    rc_q = revcomp_packed(queries, k)
    q_is_canon = (queries == canon_q).all(axis=1)

    n_hits = 0
    n_mapped = 0
    with open(opt.output, "w") as out:
        out.write("kmer_id\tkmer\tcontig\tpos\tstrand\n")
        from kmdiff_tpu_torch.core.kmer import packed_to_strings

        qstrings = packed_to_strings(queries, k)
        for qi in range(len(names)):
            a, b = lo[qi], hi[qi]
            if a == b:
                continue
            n_mapped += 1
            for j in order[a:b]:
                strand = "+" if q_is_canon[qi] else "-"
                out.write(
                    f"{names[qi]}\t{qstrings[qi]}\t"
                    f"{contig_names[ref_ci[j]]}\t{ref_pos[j]}\t{strand}\n"
                )
                n_hits += 1

    logger.info("call: %d/%d k-mers mapped, %d loci.", n_mapped, len(names),
                n_hits)
    return {"queries": len(names), "mapped": n_mapped, "hits": n_hits}
