"""Clean-room LZ4 frame/block codec (pure Python, numpy-assisted).

kmtricks stores per-partition k-mer count files and spilled accumulators as
LZ4 *frames* (reference: include/kmdiff/accumulator.hpp:165-166 uses
kmtricks' lz4_stream; the run-dir fixture files embed standard LZ4 frame
magic 0x184D2204). To interoperate without the lz4 library, this module
implements the public LZ4 block + frame formats from their specification:

  block:  sequences of [token | literals | 2B LE match offset | match copy]
  frame:  magic, FLG/BD descriptor, HC byte, 4B-LE-size-prefixed blocks,
          0x00000000 end mark, optional checksums (xxh32)

Writing supports two modes:
  - "store": uncompressed blocks (high bit of the block size set) — valid
    LZ4 frames at memcpy speed, used for our own spill files.
  - "fast": greedy hash-table LZ4 compression (pure Python; the native C++
    codec in kmdiff_tpu_torch/native supersedes it when built).

A faster C implementation is used transparently when the native library is
available (kmdiff_tpu_torch.native).
"""

from __future__ import annotations

import struct

from kmdiff_tpu_torch import native
from kmdiff_tpu_torch.utils.exceptions import FormatError

LZ4_MAGIC = 0x184D2204
_MAX_BLOCK_SIZES = {4: 1 << 16, 5: 1 << 18, 6: 1 << 20, 7: 1 << 22}


# ---------------------------------------------------------------------------
# block codec
# ---------------------------------------------------------------------------

def decompress_block(src: bytes, max_out: int | None = None) -> bytes:
    """Decode one raw LZ4 block."""
    try:
        if native.available():
            return native.lz4_decompress_block(src, max_out)
        return _decompress_block_py(src)
    except (IndexError, struct.error) as e:
        raise FormatError(f"corrupt LZ4 block: {e}") from e


def _decompress_block_py(src: bytes) -> bytes:
    out = bytearray()
    i = 0
    n = len(src)
    while i < n:
        token = src[i]
        i += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                b = src[i]
                i += 1
                lit_len += b
                if b != 255:
                    break
        out += src[i : i + lit_len]
        i += lit_len
        if i >= n:
            break  # last sequence: literals only
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0:
            raise FormatError("LZ4 block: zero match offset")
        match_len = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                b = src[i]
                i += 1
                match_len += b
                if b != 255:
                    break
        start = len(out) - offset
        if start < 0:
            raise FormatError("LZ4 block: match offset before output start")
        if offset >= match_len:
            out += out[start : start + match_len]
        else:  # overlapping copy, byte-by-byte semantics
            for j in range(match_len):
                out.append(out[start + j])
    return bytes(out)


def compress_block(src: bytes) -> bytes:
    """Greedy LZ4 block compression (hash table over 4-byte windows)."""
    if native.available():
        return native.lz4_compress_block(src)
    return _compress_block_py(src)


def _emit_sequence(out: bytearray, literals, match_off: int, match_len: int):
    lit_len = len(literals)
    token_lit = 15 if lit_len >= 15 else lit_len
    if match_len:
        ml = match_len - 4
        token_ml = 15 if ml >= 15 else ml
    else:
        token_ml = 0
    out.append((token_lit << 4) | token_ml)
    if lit_len >= 15:
        rest = lit_len - 15
        while rest >= 255:
            out.append(255)
            rest -= 255
        out.append(rest)
    out += literals
    if match_len:
        out += struct.pack("<H", match_off)
        if match_len - 4 >= 15:
            rest = match_len - 4 - 15
            while rest >= 255:
                out.append(255)
                rest -= 255
            out.append(rest)


def _compress_block_py(src: bytes) -> bytes:
    n = len(src)
    if n < 13:  # too small per spec margins: emit as pure literals
        out = bytearray()
        _emit_sequence(out, src, 0, 0)
        return bytes(out)
    out = bytearray()
    table: dict[bytes, int] = {}
    anchor = 0
    i = 0
    # spec: last match must start at least 12 bytes before end; last 5 bytes
    # are always literals
    mf_limit = n - 12
    while i <= mf_limit:
        key = src[i : i + 4]
        cand = table.get(key, -1)
        table[key] = i
        if cand >= 0 and i - cand <= 0xFFFF and src[cand : cand + 4] == key:
            match_len = 4
            limit = n - 5
            while i + match_len < limit and src[cand + match_len] == src[i + match_len]:
                match_len += 1
            _emit_sequence(out, src[anchor:i], i - cand, match_len)
            i += match_len
            anchor = i
        else:
            i += 1
    _emit_sequence(out, src[anchor:], 0, 0)
    return bytes(out)


# ---------------------------------------------------------------------------
# frame codec
# ---------------------------------------------------------------------------

def _xxh32(data: bytes, seed: int = 0) -> int:
    from kmdiff_tpu_torch.utils.xxhash import xxh32

    return xxh32(data, seed)


class Lz4FrameReader:
    """Streaming reader over a file object positioned at an LZ4 frame."""

    def __init__(self, fileobj):
        self.f = fileobj
        magic = struct.unpack("<I", self._read_exact(4))[0]
        if magic != LZ4_MAGIC:
            raise FormatError(f"bad LZ4 frame magic: {magic:#x}")
        flg = self._read_exact(1)[0]
        bd = self._read_exact(1)[0]
        version = flg >> 6
        if version != 1:
            raise FormatError(f"unsupported LZ4 frame version {version}")
        self.block_indep = bool(flg & 0x20)
        self.block_checksum = bool(flg & 0x10)
        self.content_size_flag = bool(flg & 0x08)
        self.content_checksum = bool(flg & 0x04)
        self.dict_id_flag = bool(flg & 0x01)
        bmax = (bd >> 4) & 0x7
        if bmax not in _MAX_BLOCK_SIZES:
            raise FormatError(f"bad LZ4 block max size code {bmax}")
        self.max_block_size = _MAX_BLOCK_SIZES[bmax]
        self.content_size = None
        if self.content_size_flag:
            self.content_size = struct.unpack("<Q", self._read_exact(8))[0]
        if self.dict_id_flag:
            self._read_exact(4)
        self._read_exact(1)  # header checksum byte (not verified)
        self._eof = False
        self._buf = b""
        self._pos = 0
        # block-LINKED frames need the previous 64 KiB of decoded output
        # as match history; the native continue-decoder provides that
        # (streaming stays O(64K + block) instead of whole-frame)
        self._window = b""
        if not self.block_indep:
            if not native.available():
                raise FormatError(
                    "block-linked LZ4 frame needs the native codec for "
                    "streaming reads (a C++ toolchain to build "
                    "kmdiff_tpu_torch/native)"
                )
            self._linked_decode = native.lz4_decompress_block_continue

    def _read_exact(self, n: int) -> bytes:
        data = self.f.read(n)
        if len(data) != n:
            raise FormatError("truncated LZ4 frame")
        return data

    def _next_block(self) -> bytes:
        if self._eof:
            return b""
        size = struct.unpack("<I", self._read_exact(4))[0]
        if size == 0:
            if self.content_checksum:
                self._read_exact(4)
            self._eof = True
            return b""
        uncompressed = bool(size & 0x80000000)
        size &= 0x7FFFFFFF
        data = self._read_exact(size)
        if self.block_checksum:
            self._read_exact(4)
        if uncompressed:
            out = data
        elif self.block_indep:
            out = decompress_block(data)
        else:
            out = self._linked_decode(data, self._window, self.max_block_size)
        if not self.block_indep:
            # keep the trailing 64 KiB as match history for the next block
            self._window = (self._window + out)[-65536:]
        return out

    def read(self, n: int = -1) -> bytes:
        chunks = []
        want = n if n >= 0 else None
        while want is None or want > 0:
            if self._pos >= len(self._buf):
                self._buf = self._next_block()
                self._pos = 0
                if not self._buf:
                    break
            take = len(self._buf) - self._pos if want is None else min(
                want, len(self._buf) - self._pos
            )
            chunks.append(self._buf[self._pos : self._pos + take])
            self._pos += take
            if want is not None:
                want -= take
        return b"".join(chunks)

    def read_all(self) -> bytes:
        return self.read(-1)


class Lz4FrameWriter:
    """Streaming writer producing a standard LZ4 frame.

    mode="store" writes uncompressed blocks (fast path, still a valid
    frame); mode="fast" greedily compresses each block and falls back to an
    uncompressed block when compression does not help.
    """

    def __init__(self, fileobj, block_size: int = 1 << 16, mode: str = "fast"):
        if mode not in ("store", "fast"):
            raise ValueError(f"bad LZ4 writer mode {mode}")
        self.f = fileobj
        self.mode = mode
        self.block_size = block_size
        bmax = next(
            (c for c, s in sorted(_MAX_BLOCK_SIZES.items()) if block_size <= s), 7
        )
        self.block_size = min(block_size, _MAX_BLOCK_SIZES[bmax])
        flg = (1 << 6) | 0x20  # version 01, block-independent, no checksums
        bd = bmax << 4
        header = struct.pack("<I", LZ4_MAGIC) + bytes([flg, bd])
        hc = (_xxh32(header[4:]) >> 8) & 0xFF
        self.f.write(header + bytes([hc]))
        self._pending = bytearray()
        self._closed = False

    def write(self, data: bytes) -> int:
        self._pending += data
        while len(self._pending) >= self.block_size:
            self._flush_block(bytes(self._pending[: self.block_size]))
            del self._pending[: self.block_size]
        return len(data)

    def _flush_block(self, raw: bytes):
        if self.mode == "fast":
            comp = compress_block(raw)
            if len(comp) < len(raw):
                self.f.write(struct.pack("<I", len(comp)))
                self.f.write(comp)
                return
        self.f.write(struct.pack("<I", len(raw) | 0x80000000))
        self.f.write(raw)

    def close(self):
        if self._closed:
            return
        if self._pending:
            self._flush_block(bytes(self._pending))
            self._pending.clear()
        self.f.write(struct.pack("<I", 0))  # end mark
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def frame_read_all(f, size_hint: int = 0):
    """Read the complete LZ4 frame starting at f's position.

    Uses the native one-pass frame decoder when available (returns a numpy
    uint8 array; also handles block-DEPENDENT frames, which the per-block
    Python reader cannot); falls back to Lz4FrameReader (returns bytes).
    """
    if not native.available():
        return Lz4FrameReader(f).read_all()
    return native.lz4_frame_decompress(f.read(), size_hint)


__all__ = [
    "Lz4FrameReader",
    "Lz4FrameWriter",
    "frame_read_all",
    "decompress_block",
    "compress_block",
]
