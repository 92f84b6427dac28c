"""FASTA/FASTQ -> 2-bit code stream (port of kmdiff_tpu/io/fasta.py::
flat_codes onto the port's codec; the rest of that module is host code the
port imports as it is)."""

from __future__ import annotations

import gzip

import numpy as np

from kmdiff_tpu.io.fasta import iter_records
from kmdiff_tpu_torch.ops.codec import INVALID, encode_ascii_block


def flat_codes(path: str) -> np.ndarray:
    """Vectorized FASTA/FASTQ -> 2-bit code stream for the counting engine.

    One pass over the raw bytes, no per-read Python loop: header lines
    ('>' / '@') and FASTQ '+'/quality lines are masked to INVALID, so they
    break k-mer windows exactly like read boundaries; newlines are then
    deleted, which joins multi-line FASTA sequences while the masked header
    between reads still separates them. Malformed FASTQ (not strict 4-line
    records) goes through the record parser instead.
    """
    if str(path).endswith(".gz"):
        with gzip.open(path, "rb") as f:
            buf = np.frombuffer(f.read(), dtype=np.uint8)
    else:
        with open(path, "rb") as f:
            buf = np.frombuffer(f.read(), dtype=np.uint8)
    if len(buf) == 0:
        return np.zeros(0, np.uint8)

    codes = encode_ascii_block(buf)
    nl = buf == 0x0A
    # line starts: position 0 + every position after a newline
    starts = np.flatnonzero(np.concatenate([[True], nl[:-1]]))
    starts = starts[starts < len(buf)]
    first = buf[starts]

    if buf[0] == 0x3E:  # '>' FASTA
        ends = np.append(starts[1:], len(buf))
        hdr = first == 0x3E
        mask = np.zeros(len(buf) + 1, np.int8)
        np.add.at(mask, starts[hdr], 1)
        np.add.at(mask, ends[hdr], -1)
        codes[np.cumsum(mask[:-1]) > 0] = INVALID
    elif buf[0] == 0x40:  # '@' FASTQ
        if len(starts) % 4 == 0 and (buf[starts[0::4]] == 0x40).all() and (
            buf[starts[2::4]] == 0x2B
        ).all():
            ends = np.append(starts[1:], len(buf))
            keep_line = np.zeros(len(starts), bool)
            keep_line[1::4] = True  # sequence lines only
            mask = np.zeros(len(buf) + 1, np.int8)
            np.add.at(mask, starts[~keep_line], 1)
            np.add.at(mask, ends[~keep_line], -1)
            codes[np.cumsum(mask[:-1]) > 0] = INVALID
        else:  # malformed / multi-line FASTQ: generic parser
            joined = b"\xff".join(seq.encode() for _n, seq in iter_records(path))
            return encode_ascii_block(np.frombuffer(joined, dtype=np.uint8))
    else:
        raise ValueError(f"{path}: not FASTA/FASTQ")

    return codes[~nl]
