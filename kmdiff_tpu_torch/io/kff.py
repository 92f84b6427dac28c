"""Clean-room KFF (k-mer file format) v1.0 reader/writer.

Implements the public KFF specification (Kmer-File-Format, Dufresne et al.,
Bioinformatics 2022) for the subset the reference emits with --kff-output
(reference: include/kmdiff/kff_utils.hpp:32-169 via kff-cpp-api):

  header : "KFF" | u8 major=1 | u8 minor=0 | u8 encoding | u8 uniqueness |
           u8 canonicity | u32 BE free_size | free bytes
  'v'    : global-variables section: u64 BE nb_vars, then per var a
           NUL-terminated name + u64 BE value (k, max, data_size)
  'r'    : raw section: u64 BE nb_blocks; per block (max==1 so the in-block
           k-mer count field is omitted): ceil(k/4) bytes of 2-bit codes,
           big-endian within each byte, left-padded in the FIRST byte —
           followed by data_size bytes of per-kmer data (0 here)
  footer : "KFF" magic again (lets readers detect truncation)

Encoding byte packs the 2-bit codes of A,C,G,T in that order; the reference
uses {A:0, C:1, G:3, T:2} (kff_utils.hpp:39) = 0b00011110.
All multi-byte integers are big-endian per the KFF spec.
"""

from __future__ import annotations

import struct

from kmdiff_tpu_torch.utils.exceptions import FormatError

MAGIC = b"KFF"
#: (ascii >> 1) & 3 codes for A, C, G, T — matches the 2-bit codec in
#: core.kmer
ENCODING = (0, 1, 3, 2)


def _encoding_byte(enc=ENCODING) -> int:
    a, c, g, t = enc
    return (a << 6) | (c << 4) | (g << 2) | t


def pack_2bit_strings(seqs: list[str]) -> list[bytes]:
    return [pack_2bit(s) for s in seqs]


def pack_2bit(seq: str) -> bytes:
    """2-bit pack with the final bases right-aligned: the first byte holds
    k % 4 bases (left-padded with zero bits), matching the reference's
    encode_sequence (kff_utils.hpp:74-101)."""
    codes = [((ord(ch) >> 1) & 3) for ch in seq]
    k = len(codes)
    rem = k % 4
    out = bytearray()
    pos = 0
    if rem:
        val = 0
        for i in range(rem):
            val = (val << 2) | codes[i]
        out.append(val)
        pos = rem
    while pos < k:
        val = 0
        for i in range(4):
            val = (val << 2) | codes[pos + i]
        out.append(val)
        pos += 4
    return bytes(out)


def unpack_2bit(data: bytes, k: int) -> str:
    nt = "ACTG"  # index by 2-bit code
    codes = []
    for byte in data:
        for shift in (6, 4, 2, 0):
            codes.append((byte >> shift) & 3)
    codes = codes[len(codes) - k :] if k % 4 else codes
    return "".join(nt[c] for c in codes[:k])


class KffWriter:
    """Raw-section writer for significant k-mers (max=1, data_size=0)."""

    def __init__(self, path: str, kmer_size: int):
        self.kmer_size = kmer_size
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self._f.write(bytes([1, 0, _encoding_byte(), 0, 0]))
        self._f.write(struct.pack(">I", 0))  # free_size
        # global variables section
        self._f.write(b"v")
        self._f.write(struct.pack(">Q", 3))
        for name, val in (("k", kmer_size), ("max", 1), ("data_size", 0)):
            self._f.write(name.encode() + b"\x00")
            self._f.write(struct.pack(">Q", val))
        # raw section: block count back-patched on close
        self._f.write(b"r")
        self._nb_pos = self._f.tell()
        self._f.write(struct.pack(">Q", 0))
        self._n = 0

    def write_kmer(self, seq: str) -> None:
        if len(seq) != self.kmer_size:
            raise ValueError(f"k-mer length {len(seq)} != k={self.kmer_size}")
        self._f.write(pack_2bit(seq))
        self._n += 1

    def close(self) -> None:
        end = self._f.tell()
        self._f.seek(self._nb_pos)
        self._f.write(struct.pack(">Q", self._n))
        self._f.seek(end)
        self._f.write(MAGIC)
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class KffReader:
    """Reads back the writer's subset (v + r sections, max=1)."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        if self._f.read(3) != MAGIC:
            raise FormatError(f"{path}: not a KFF file")
        self.major, self.minor, enc, self.uniqueness, self.canonicity = self._f.read(5)
        self.encoding = ((enc >> 6) & 3, (enc >> 4) & 3, (enc >> 2) & 3, enc & 3)
        (free_size,) = struct.unpack(">I", self._f.read(4))
        self._f.read(free_size)
        self.vars: dict[str, int] = {}

    def _read_var_section(self):
        (n,) = struct.unpack(">Q", self._f.read(8))
        for _ in range(n):
            name = bytearray()
            while (b := self._f.read(1)) not in (b"\x00", b""):
                name.extend(b)
            (val,) = struct.unpack(">Q", self._f.read(8))
            self.vars[name.decode()] = val

    def kmers(self):
        """Yield k-mer strings from every raw section."""
        while True:
            stype = self._f.read(1)
            if not stype:
                return
            if stype == b"v":
                self._read_var_section()
            elif stype == b"r":
                k = self.vars["k"]
                data_size = self.vars.get("data_size", 0)
                if self.vars.get("max", 1) != 1:
                    raise FormatError("reader supports max=1 sections only")
                (nb,) = struct.unpack(">Q", self._f.read(8))
                nbytes = (k + 3) // 4
                for _ in range(nb):
                    raw = self._f.read(nbytes)
                    self._f.read(data_size)
                    yield unpack_2bit(raw, k)
            elif stype == b"K":  # start of footer magic "KFF"
                return
            else:
                raise FormatError(f"unsupported KFF section {stype!r}")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
