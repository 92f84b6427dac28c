"""Significant-k-mer accumulators: columnar hit buffers with LZ4 disk spill.

Reference: include/kmdiff/accumulator.hpp:36-289 — per-partition buffers of
KmerSign records with three strategies (in-memory vector, dedup set,
lz4-compressed spill file; the port uses the vector and the spill file).
Re-designed struct-of-arrays: hits move between device and disk as column
blocks (kmers [n, nw] u64, pvalue [n] f64, sign [n] i8, means [n] f64,
optional counts_ratio [n, S] f64), which is both the device-friendly
layout and ~10x cheaper to (de)serialize than per-record virtual dispatch.

Spill files are LZ4 frames with a small header; they are the checkpoint
artifacts the resume logic probes for (reference: diff.hpp:289-303,
accumulator.cpp:9-17 partitions_exist).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

from kmdiff_tpu_torch.io.lz4 import Lz4FrameReader, Lz4FrameWriter
from kmdiff_tpu_torch.utils.exceptions import FormatError

MAGIC = b"KMDTACC1"


@dataclass
class KmerSignBlock:
    """A block of significant k-mers (struct-of-arrays KmerSign,
    reference: include/kmdiff/kmer.hpp:55-147)."""

    kmers: np.ndarray  # [n, n_words] uint64
    pvalues: np.ndarray  # [n] float64
    signs: np.ndarray  # [n] int8 (Significance)
    mean_control: np.ndarray  # [n] float64
    mean_case: np.ndarray  # [n] float64
    counts_ratio: np.ndarray | None = None  # [n, S] float64 (popstrat path)

    def __len__(self):
        return len(self.pvalues)

    @staticmethod
    def empty(n_words: int, nb_samples: int = 0) -> "KmerSignBlock":
        return KmerSignBlock(
            np.zeros((0, n_words), dtype=np.uint64),
            np.zeros(0, dtype=np.float64),
            np.zeros(0, dtype=np.int8),
            np.zeros(0, dtype=np.float64),
            np.zeros(0, dtype=np.float64),
            np.zeros((0, nb_samples), dtype=np.float64) if nb_samples else None,
        )

    @staticmethod
    def concat(blocks: list["KmerSignBlock"]) -> "KmerSignBlock":
        if not blocks:
            raise ValueError("no blocks")
        cr = None
        if blocks[0].counts_ratio is not None:
            cr = np.concatenate([b.counts_ratio for b in blocks])
        return KmerSignBlock(
            np.concatenate([b.kmers for b in blocks]),
            np.concatenate([b.pvalues for b in blocks]),
            np.concatenate([b.signs for b in blocks]),
            np.concatenate([b.mean_control for b in blocks]),
            np.concatenate([b.mean_case for b in blocks]),
            cr,
        )

    def take(self, idx) -> "KmerSignBlock":
        return KmerSignBlock(
            self.kmers[idx],
            self.pvalues[idx],
            self.signs[idx],
            self.mean_control[idx],
            self.mean_case[idx],
            None if self.counts_ratio is None else self.counts_ratio[idx],
        )


class IAccumulator:
    """push blocks -> finish -> iterate blocks -> destroy."""

    def push_block(self, block: KmerSignBlock) -> None:
        raise NotImplementedError

    def finish(self) -> None:
        raise NotImplementedError

    def blocks(self):
        """Iterate KmerSignBlocks after finish()."""
        raise NotImplementedError

    def destroy(self) -> None:  # noqa: B027
        pass


class VectorAccumulator(IAccumulator):
    """In-memory (reference: accumulator.hpp VectorAccumulator)."""

    def __init__(self):
        self._blocks: list[KmerSignBlock] = []

    def push_block(self, block):
        self._blocks.append(block)

    def finish(self):
        pass

    def blocks(self):
        yield from self._blocks

    def destroy(self):
        self._blocks = []


class FileAccumulator(IAccumulator):
    """LZ4-spill accumulator (reference: accumulator.hpp:156-285,
    default in the diff pipeline; files double as resume checkpoints).

    File layout: MAGIC | u32 kmer_size | u32 n_words | u32 nb_samples |
    LZ4 frame of concatenated blocks, each:
      u64 n | kmers | pvalues | signs | mean_control | mean_case | ratios?

    Spills are written under `<path>.part` and renamed to `path` on
    finish(): a crash mid-spill leaves no file at the final name, so a
    resume's partitions_exist probe never re-opens a truncated spill (the
    reference probes bare existence and would, src/accumulator.cpp:9-17).
    """

    def __init__(self, path: str, kmer_size: int, read: bool = False,
                 delete_on_destroy: bool = False, nb_samples: int = 0,
                 lz4_mode: str = "fast"):
        from kmdiff_tpu_torch.core.kmer import n_words

        self.path = path
        self.kmer_size = kmer_size
        self.n_words = n_words(kmer_size) if kmer_size else 0
        self.nb_samples = nb_samples
        self.delete_on_destroy = delete_on_destroy
        self._reading = read
        self._raw = None
        self._writer = None
        if read:
            self._open_read()
        else:
            self._raw = open(path + ".part", "wb")
            self._raw.write(MAGIC)
            self._raw.write(struct.pack("<III", kmer_size, self.n_words, nb_samples))
            # 1 MiB blocks: spills are our own format (no kmtricks reader
            # to humor) and bigger blocks amortize the codec's per-block cost
            self._writer = Lz4FrameWriter(self._raw, block_size=1 << 20,
                                          mode=lz4_mode)

    def _open_read(self):
        self._raw = open(self.path, "rb")
        magic = self._raw.read(8)
        if magic != MAGIC:
            raise FormatError(f"{self.path}: not an accumulator spill file")
        self.kmer_size, self.n_words, self.nb_samples = struct.unpack(
            "<III", self._raw.read(12)
        )
        self._reader = Lz4FrameReader(self._raw)

    def push_block(self, block: KmerSignBlock):
        n = len(block)
        if n == 0:
            return
        w = self._writer
        w.write(struct.pack("<Q", n))
        w.write(np.ascontiguousarray(block.kmers, dtype="<u8").tobytes())
        w.write(np.ascontiguousarray(block.pvalues, dtype="<f8").tobytes())
        w.write(np.ascontiguousarray(block.signs, dtype=np.int8).tobytes())
        w.write(np.ascontiguousarray(block.mean_control, dtype="<f8").tobytes())
        w.write(np.ascontiguousarray(block.mean_case, dtype="<f8").tobytes())
        if self.nb_samples:
            if block.counts_ratio is None:
                raise ValueError("accumulator expects counts_ratio blocks")
            w.write(np.ascontiguousarray(block.counts_ratio, dtype="<f8").tobytes())

    def finish(self):
        if self._writer is not None:
            self._writer.close()
            self._raw.close()
            self._writer = None
            os.replace(self.path + ".part", self.path)
        self._open_read()
        self._reading = True

    def blocks(self):
        r = self._reader
        while True:
            head = r.read(8)
            if len(head) < 8:
                return
            (n,) = struct.unpack("<Q", head)
            kmers = np.frombuffer(r.read(n * self.n_words * 8), dtype="<u8").reshape(
                n, self.n_words
            )
            pvalues = np.frombuffer(r.read(n * 8), dtype="<f8")
            signs = np.frombuffer(r.read(n), dtype=np.int8)
            mc = np.frombuffer(r.read(n * 8), dtype="<f8")
            mk = np.frombuffer(r.read(n * 8), dtype="<f8")
            cr = None
            if self.nb_samples:
                cr = np.frombuffer(
                    r.read(n * self.nb_samples * 8), dtype="<f8"
                ).reshape(n, self.nb_samples)
            yield KmerSignBlock(kmers.copy(), pvalues.copy(), signs.copy(),
                                mc.copy(), mk.copy(),
                                None if cr is None else cr.copy())

    def destroy(self):
        dangling_part = self._writer is not None
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        if self._raw is not None:
            self._raw.close()
            self._raw = None
        if dangling_part and os.path.exists(self.path + ".part"):
            os.remove(self.path + ".part")  # never-finished spill
        if self.delete_on_destroy and os.path.exists(self.path):
            os.remove(self.path)


def partitions_exist(pattern: str, nb_partitions: int, directory: str) -> bool:
    """Probe for spilled partition files (reference: src/accumulator.cpp:9-17);
    pattern example: "{}/p{}_uncorrected"."""
    return all(
        os.path.exists(pattern.format(directory, i)) for i in range(nb_partitions)
    )
