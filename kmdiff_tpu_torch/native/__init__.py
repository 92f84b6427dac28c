"""Native host-IO library loader (ctypes, no pybind11).

Provides C++ LZ4 block and frame (de)compression, the k-mer record
(un)packing of the count files, the k-way merge of counted streams and the
stable partition regroup for the hot host paths: count-file decode and
encode, accumulator spills and the per-sample merge of `count` (the
reference links upstream lz4 for the same jobs,
thirdparty/CMakeLists.txt:103-115).

The library is built from this directory's sources with ``make`` at its
first use in a process, never at import, into
``build/kmdiff_tpu_torch/native/`` under the checkout; the file name carries
a hash of the sources and the Makefile, so an edited source is rebuilt and
a stale library is never loaded. Where no toolchain is present,
``available()`` is False (logged once, at warning level) and every caller
takes its pure-Python or numpy path (io.lz4, io.kmtricks, pipeline.count).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [
    os.path.join(_DIR, "lz4_codec.cpp"),
    os.path.join(_DIR, "io_codec.cpp"),
]
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "kmdiff_tpu_torch", "native")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> str:
    h = hashlib.sha1()
    for path in [*_SRCS, os.path.join(_DIR, "Makefile")]:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libkmdiff_native-{h.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    """Compile the library into `out` (a per-process temporary, then an
    atomic rename, so concurrent builders never load a half-written file)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["make", "-f", os.path.join(_DIR, "Makefile"), f"SRC_DIR={_DIR}",
             f"OUT={tmp}"],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def lib():
    """The loaded library, built on first use; None without a toolchain."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            out = library_path()
            try:
                if not os.path.exists(out):
                    _build(out)
                _lib = _bind(ctypes.CDLL(out))
            except (subprocess.SubprocessError, OSError) as e:
                from kmdiff_tpu_torch.utils.logging import logger

                logger.warning("native host-IO library unavailable (%s); "
                               "using the pure-Python LZ4 codec and numpy "
                               "merges.", e)
    return _lib


def available() -> bool:
    return lib() is not None


def _bind(lib):
    lib.lz4_decompress_block.restype = ctypes.c_long
    lib.lz4_decompress_block.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
    ]
    lib.lz4_compress_block.restype = ctypes.c_long
    lib.lz4_compress_block.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
    ]
    lib.lz4_compress_bound.restype = ctypes.c_long
    lib.lz4_compress_bound.argtypes = [ctypes.c_long]
    lib.lz4_decompress_block_continue.restype = ctypes.c_long
    lib.lz4_decompress_block_continue.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_long,
    ]
    lib.lz4_frame_decompress.restype = ctypes.c_long
    lib.lz4_frame_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
    ]
    lib.lz4_frame_compress.restype = ctypes.c_long
    lib.lz4_frame_compress.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_int, ctypes.c_long,
    ]
    lib.lz4_frame_compress_bound.restype = ctypes.c_long
    lib.lz4_frame_compress_bound.argtypes = [ctypes.c_long, ctypes.c_long]
    lib.split_kmer_records.restype = ctypes.c_long
    lib.split_kmer_records.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.pack_kmer_records.restype = ctypes.c_long
    lib.pack_kmer_records.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.merge_counted_streams.restype = ctypes.c_long
    lib.merge_counted_streams.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.partition_regroup.restype = ctypes.c_long
    lib.partition_regroup.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    return lib


def _loaded():
    handle = lib()
    if handle is None:
        raise RuntimeError("the native host-IO library is unavailable "
                           "(check available() first)")
    return handle


def lz4_decompress_block(src: bytes, max_out: int | None = None) -> bytes:
    """Decode one raw LZ4 block. max_out caps the output buffer; when
    unknown, a worst-case expansion bound is used and doubled on demand."""
    cap = max_out if max_out else max(len(src) * 4, 1 << 16)
    while True:
        buf = ctypes.create_string_buffer(cap)
        n = _loaded().lz4_decompress_block(src, len(src), buf, cap)
        if n >= 0:
            return buf.raw[:n]
        if n == -2 and not max_out and cap < (1 << 31):
            cap *= 4
            continue
        from kmdiff_tpu_torch.utils.exceptions import FormatError

        raise FormatError(f"corrupt LZ4 block (native rc={n})")


def lz4_compress_block(src: bytes) -> bytes:
    cap = _loaded().lz4_compress_bound(len(src))
    buf = ctypes.create_string_buffer(cap)
    n = _loaded().lz4_compress_block(src, len(src), buf, cap)
    if n < 0:
        from kmdiff_tpu_torch.utils.exceptions import FormatError

        raise FormatError("LZ4 compression failed (buffer bound)")
    return buf.raw[:n]


def lz4_decompress_block_continue(src: bytes, window: bytes,
                                  max_out: int | None = None) -> bytes:
    """Decode one block of a block-LINKED LZ4 frame given the previous
    ≤64 KiB of decoded history. Returns the new bytes only."""
    hist = len(window)
    cap = hist + (max_out if max_out else max(len(src) * 4, 1 << 16))
    while True:
        buf = ctypes.create_string_buffer(cap)
        buf[:hist] = window
        n = _loaded().lz4_decompress_block_continue(src, len(src), buf, hist, cap)
        if n >= 0:
            return buf.raw[hist : hist + n]
        if n == -2 and not max_out and cap < (1 << 31):
            cap = hist + (cap - hist) * 4
            continue
        from kmdiff_tpu_torch.utils.exceptions import FormatError

        raise FormatError(f"corrupt LZ4 linked block (native rc={n})")


def _lz4_frame_content_size(src) -> int | None:
    """The frame header's optional content-size field (FLG bit 3), when
    present — lets the output buffer be sized in one step."""
    if len(src) >= 15 and bytes(src[:4]) == b"\x04\x22\x4d\x18":
        flg = src[4]
        if (flg >> 6) == 0b01 and flg & 0x08:  # version 01, C.Size set
            return int.from_bytes(bytes(src[6:14]), "little")
    return None


def lz4_frame_decompress(src: bytes, size_hint: int = 0):
    """Decode a whole LZ4 frame in one native pass (handles both block-
    independent and block-dependent frames). Returns a numpy uint8 array."""
    import numpy as np

    # a frame can only expand ~255x per LZ4 spec; sizing or retrying past
    # that is a decompression bomb or corruption, not a short buffer
    expand_max = 256 * max(len(src), 1) + (1 << 16)
    declared = _lz4_frame_content_size(src)
    cap = max(int(size_hint), 4 * len(src), 1 << 16)
    if declared is not None:
        cap = max(min(declared, expand_max), 1 << 10)
    limit = min(max(cap, expand_max, int(size_hint)), 1 << 34)
    while True:
        out = np.empty(cap, dtype=np.uint8)
        n = _loaded().lz4_frame_decompress(
            src, len(src), out.ctypes.data, cap
        )
        if n >= 0:
            return out[:n]
        if n == -2 and cap < limit:
            cap = min(cap * 4, limit)
            continue
        from kmdiff_tpu_torch.utils.exceptions import FormatError

        raise FormatError(f"corrupt LZ4 frame (native rc={n})")


def lz4_frame_compress(src, mode: str = "fast", block_size: int = 1 << 16):
    """Compress a buffer (bytes or C-contiguous uint8 numpy array) into a
    complete LZ4 frame. Returns a numpy uint8 array."""
    import numpy as np

    if mode not in ("store", "fast"):
        raise ValueError(f"bad LZ4 writer mode {mode}")
    src = np.ascontiguousarray(
        np.frombuffer(src, dtype=np.uint8) if isinstance(src, (bytes, bytearray))
        else src.reshape(-1).view(np.uint8)
    )
    n = len(src)
    cap = _loaded().lz4_frame_compress_bound(n, block_size)
    out = np.empty(cap, dtype=np.uint8)
    w = _loaded().lz4_frame_compress(
        src.ctypes.data, n, out.ctypes.data, cap,
        1 if mode == "fast" else 0, block_size,
    )
    if w < 0:
        from kmdiff_tpu_torch.utils.exceptions import FormatError

        raise FormatError("LZ4 frame compression failed (buffer bound)")
    return out[:w]


def split_kmer_records(payload, n: int, nw: int, cbytes: int, slots: int = 1):
    """payload [n * rec] uint8 -> (kmers [n, nw] u64, counts [n(, slots)]
    u32) in one native pass (records: nw x u64 LE + slots x cbytes LE)."""
    import numpy as np

    payload = np.ascontiguousarray(payload, dtype=np.uint8)
    kmers = np.empty((n, nw), dtype=np.uint64)
    counts = np.empty((n, slots), dtype=np.uint32)
    rc = _loaded().split_kmer_records(
        payload.ctypes.data, n, nw, cbytes, slots,
        kmers.ctypes.data, counts.ctypes.data,
    )
    if rc < 0:
        raise ValueError(
            f"split_kmer_records: bad layout (nw={nw}, cbytes={cbytes}, "
            f"slots={slots})"
        )
    return kmers, (counts[:, 0] if slots == 1 else counts)


def merge_counted_streams(kmers_list, counts_list):
    """K-way merge of k-mer-sorted (kmers [n, nw] u64, counts [n] u32)
    streams, summing counts of equal k-mers. Returns (kmers, counts)."""
    import numpy as np

    kmers = np.ascontiguousarray(np.concatenate(kmers_list), dtype=np.uint64)
    counts = np.ascontiguousarray(np.concatenate(counts_list), dtype=np.uint32)
    offsets = np.zeros(len(kmers_list) + 1, dtype=np.int64)
    np.cumsum([len(k) for k in kmers_list], out=offsets[1:])
    n, nw = kmers.shape
    out_k = np.empty_like(kmers)
    out_c = np.empty_like(counts)
    m = _loaded().merge_counted_streams(
        kmers.ctypes.data, counts.ctypes.data, offsets.ctypes.data,
        len(kmers_list), nw, out_k.ctypes.data, out_c.ctypes.data,
    )
    if m < 0:
        raise ValueError("merge_counted_streams: too many streams")
    return out_k[:m], out_c[:m]


def partition_regroup(parts, kmers, counts, nparts: int):
    """Stable counting-sort regroup of (kmers, parts, counts) rows by
    partition id. Returns new arrays sorted by (part, original order)."""
    import numpy as np

    parts = np.ascontiguousarray(parts, dtype=np.uint32)
    kmers = np.ascontiguousarray(kmers, dtype=np.uint64)
    counts = np.ascontiguousarray(counts, dtype=np.uint32)
    n, nw = kmers.shape
    out_k = np.empty_like(kmers)
    out_p = np.empty_like(parts)
    out_c = np.empty_like(counts)
    rc = _loaded().partition_regroup(
        parts.ctypes.data, kmers.ctypes.data, counts.ctypes.data, n, nw,
        nparts, out_k.ctypes.data, out_p.ctypes.data, out_c.ctypes.data,
    )
    if rc < 0:
        raise ValueError(f"partition_regroup failed (rc={rc})")
    return out_k, out_p, out_c


def pack_kmer_records(kmers, counts, cbytes: int):
    """Inverse of split_kmer_records: returns the record payload as a numpy
    uint8 array. counts may be [n] or [n, slots] (any unsigned dtype)."""
    import numpy as np

    kmers = np.ascontiguousarray(kmers, dtype=np.uint64)
    n, nw = kmers.shape
    counts = np.ascontiguousarray(counts, dtype=np.uint32)
    slots = 1 if counts.ndim == 1 else counts.shape[1]
    payload = np.empty(n * (nw * 8 + cbytes * slots), dtype=np.uint8)
    rc = _loaded().pack_kmer_records(
        kmers.ctypes.data, counts.ctypes.data, n, nw, cbytes, slots,
        payload.ctypes.data,
    )
    if rc < 0:
        raise ValueError(
            f"pack_kmer_records: bad layout (nw={nw}, cbytes={cbytes}, "
            f"slots={slots})"
        )
    return payload
