"""FASTA/FASTQ IO (port of kmdiff_tpu/io/fasta.py).

Writer emits the reference's significant-k-mer record format
(reference: include/kmdiff/aggregator.hpp:51-69):
  >{rank}_pval={p:%g}_control={int(mean_control)}_case={mean_case}
  {kmer}
where mean_control is integer-truncated and mean_case printed as the C++
default double format (integral doubles print without a decimal point).

Reader handles FASTA and FASTQ, plain or gzip, multi-line sequences, and
flat_codes turns a file into the 2-bit code stream of the counting engine
(ops.codec) on the host. device_codes gives the same codes on a device: the
host reads the file's bytes into a reused staging buffer (FileStaging,
page-locked for a card), they go to the device in one copy, and K-FASTA
(ops.codec.fasta_codes) decodes them there.
"""

from __future__ import annotations

import gzip
import io
import os
import threading

import numpy as np
import torch

from kmdiff_tpu_torch import profiling
from kmdiff_tpu_torch.ops.codec import INVALID, encode_ascii_block, fasta_codes


def format_double(v: float) -> str:
    """C++ fmt/std::format default double formatting: shortest round-trip,
    no trailing '.0' on integral values."""
    if v == int(v) and abs(v) < 1e16:
        return str(int(v))
    return repr(float(v))


def format_header(rank: int, pvalue: float, mean_control: float, mean_case: float) -> str:
    return (
        f"{rank}_pval={pvalue:g}_control={int(mean_control)}_case="
        f"{format_double(mean_case)}"
    )


class FastaWriter:
    """Streaming FASTA writer (one-line sequences; k-mers are short)."""

    def __init__(self, path: str):
        self._f = open(path, "w")

    def write(self, name: str, seq: str) -> None:
        self._f.write(f">{name}\n{seq}\n")

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _open_text(path: str):
    path = str(path)
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path)


def iter_records(path: str):
    """Yield (name, seq) from FASTA or FASTQ, plain or .gz."""
    with _open_text(path) as f:
        line = f.readline()
        while line and not line.strip():
            line = f.readline()
        if not line:
            return
        if line.startswith(">"):
            name = line[1:].rstrip()
            chunks: list[str] = []
            for line in f:
                if line.startswith(">"):
                    yield name, "".join(chunks)
                    name, chunks = line[1:].rstrip(), []
                else:
                    chunks.append(line.strip())
            yield name, "".join(chunks)
        elif line.startswith("@"):
            while line:
                name = line[1:].rstrip()
                seq = f.readline().rstrip()
                f.readline()  # '+' separator
                f.readline()  # qualities
                yield name, seq
                line = f.readline()
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ (starts with {line[:1]!r})")


def read_sequences(path: str) -> list[bytes]:
    """All sequences of a FASTA/FASTQ file as ascii bytes."""
    return [seq.encode() for _name, seq in iter_records(path)]


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
            return record_codes(path)
    else:
        raise ValueError(f"{path}: not FASTA/FASTQ")

    return codes[~nl]


def record_codes(path: str) -> np.ndarray:
    """The record parser's code stream: each record's sequence, joined by
    one INVALID code (flat_codes' way with a FASTQ file that is not strict
    four-line records)."""
    joined = b"\xff".join(seq.encode() for _n, seq in iter_records(path))
    return encode_ascii_block(np.frombuffer(joined, dtype=np.uint8))


class FileStaging:
    """Host buffers that file bytes are read into on their way to
    `device`: one a thread, page-locked when the device is a card, reused
    file after file and grown to the largest file read; close() lets them
    go. A context manager."""

    def __init__(self, device: torch.device):
        self._pin = device.type == "cuda"
        self._buffers: dict[int, torch.Tensor] = {}  # thread id -> buffer

    def _buffer(self, nbytes: int, keep: int = 0) -> torch.Tensor:
        """This thread's buffer, grown to at least nbytes (at least twice
        its size), with its first `keep` bytes kept."""
        me = threading.get_ident()
        buf = self._buffers.get(me)
        if buf is None or buf.numel() < nbytes:
            grown = torch.empty(max(nbytes, 0 if buf is None else 2 * buf.numel()),
                                dtype=torch.uint8, pin_memory=self._pin)
            if keep:
                grown[:keep] = buf[:keep]
            buf = self._buffers[me] = grown
        return buf

    def read(self, path: str) -> torch.Tensor:
        """The file's bytes (a .gz inflated) as a view of this thread's
        buffer, valid until this thread's next read."""
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "rb") as f:
            # one byte past the size: the read that finds the end fits
            buf = self._buffer(os.fstat(f.fileno()).st_size + 1)
            n = 0
            while True:
                if n == buf.numel():
                    buf = self._buffer(n + 1, keep=n)
                got = f.readinto(buf.numpy()[n:])
                if not got:
                    return buf[:n]
                n += got

    def close(self) -> None:
        self._buffers.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def device_codes(path: str, device: torch.device,
                 staging: FileStaging) -> torch.Tensor:
    """flat_codes(path) as a uint8 tensor on `device`, decoded there: the
    file's bytes are read into this thread's staging buffer, copied to the
    device (non-blocking from page-locked memory) and decoded by K-FASTA
    (its plain twin on the CPU), whose read of the code count is the one
    host sync; the buffer is free again once it returns. A FASTQ file
    that is not strict four-line records takes the record parser on the
    host, as in flat_codes. The read and the decode are ``kmd:parse`` spans,
    the copy a ``kmd:h2d`` span; a collecting command tallies the files
    under ``parse_files`` and those the record parser took under
    ``parse_fallback_files`` (profiling)."""
    with profiling.span("kmd:parse"):
        host = staging.read(path)
    fastq = False
    if host.numel():
        first = int(host[0])
        if first not in (0x3E, 0x40):  # '>' FASTA, '@' FASTQ
            raise ValueError(f"{path}: not FASTA/FASTQ")
        fastq = first == 0x40
    with profiling.span("kmd:h2d"):
        raw = host.to(device, non_blocking=True)
    with profiling.span("kmd:parse"):
        codes, strict = fasta_codes(raw, fastq)
        if not strict:
            codes = torch.from_numpy(record_codes(path)).to(device)
    profiling.tally("parse_files")
    profiling.tally("parse_fallback_files", int(not strict))
    return codes
