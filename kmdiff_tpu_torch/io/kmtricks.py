"""kmtricks run-directory interop: readers/writers for the on-disk formats.

The reference consumes a kmtricks run directory (reference:
src/kmtricks_utils.cpp:29-151, include/kmdiff/kmtricks_utils.hpp:44-62).
kmdiff-tpu both *reads* kmtricks-produced run dirs (so users can switch with
existing data) and *writes* compatible ones from its own TPU counting path.

Binary layouts were reverse-engineered from the reference's checked-in
fixture (tests/data_test/km_out_dir, produced by kmtricks v1.1.1):

kmer count file (counts/partition_P/<sample>.kmer.lz4):
  0-7    magic   "kmtricks"
  8-11   u32     version (0)
  12     u8      compressed (1 => payload is one LZ4 frame)
  13-20  char[8] type "kmer"
  21-24  u32     kmer_size
  25-28  u32     count slots (1)
  29-32  u32     count bytes (1|2|4)
  33-36  u32     sample index
  37-40  u32     partition index
  41-    payload: records of [ceil(k/32) little-endian u64 words | count]

histogram file (histograms/<sample>.hist):
  0-7    magic "kmtricks" / 8-11 u32 version / 12 u8 compressed(0)
  13-20  char[8] type "khist"
  21-24  u32 kmer_size / 25-28 u32 sample idx
  29-36  u64 lower / 37-44 u64 upper
  45-52  u64 unique / 53-60 u64 total (k-mer mass, sum of counts)
  61-76  u64 oversize_unique, u64 oversize_total
  77-92  2x u64 reserved (0)
  93-    u64 unique_per_bin[upper-lower+1], u64 mass_per_bin[upper-lower+1]

fof (kmtricks.fof): lines "ID : path1; path2 ... [! ab_min]"
options: `kmdiff-count.opt` or kmtricks `options.txt` (key=value, comma-sep)
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

import numpy as np

from kmdiff_tpu_torch import native
from kmdiff_tpu_torch.io.lz4 import Lz4FrameReader, Lz4FrameWriter, frame_read_all
from kmdiff_tpu_torch.utils.exceptions import ConfigError, FormatError
from kmdiff_tpu_torch.core.kmer import n_words

MAGIC = b"kmtricks"


# ---------------------------------------------------------------------------
# config / fof
# ---------------------------------------------------------------------------

@dataclass
class KmtricksConfig:
    kmer_size: int = 0
    nb_partitions: int = 0
    abundance_min: int = 0

def read_config(run_dir: str) -> KmtricksConfig:
    """Parse run-dir config (reference: src/kmtricks_utils.cpp:29-69):
    prefers kmdiff-count.opt, falls back to kmtricks options.txt; partition
    count = number of subdirectories of counts/."""
    cfg = KmtricksConfig()
    path = os.path.join(run_dir, "kmdiff-count.opt")
    ab_key = "abundance_min"
    if not os.path.exists(path):
        path = os.path.join(run_dir, "options.txt")
        ab_key = "c_ab_min"
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                if "kmer_size" not in line:
                    continue
                for opt in line.split(","):
                    opt = opt.strip()
                    if "=" not in opt:
                        continue
                    key, _, val = opt.partition("=")
                    key = key.strip()
                    val = val.strip()
                    if "kmer_size" in key:
                        cfg.kmer_size = int(val)
                    elif ab_key in key:
                        cfg.abundance_min = int(val)
    counts_dir = os.path.join(run_dir, "counts")
    if os.path.isdir(counts_dir):
        cfg.nb_partitions = len(os.listdir(counts_dir))
    if not cfg.kmer_size or not cfg.nb_partitions:
        raise ConfigError(f"Unable to load config from {path}.")
    return cfg


@dataclass
class FofEntry:
    id: str
    paths: list[str]
    ab_min: int = 0


@dataclass
class Fof:
    entries: list[FofEntry] = field(default_factory=list)

    @classmethod
    def parse(cls, path: str) -> "Fof":
        entries = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                sid, _, rest = line.partition(":")
                ab_min = 0
                if "!" in rest:
                    rest, _, ab = rest.partition("!")
                    ab_min = int(ab.strip())
                paths = [p.strip() for p in rest.split(";") if p.strip()]
                entries.append(FofEntry(sid.strip(), paths, ab_min))
        return cls(entries)

    def get_id(self, i: int) -> str:
        return self.entries[i].id

    def __len__(self):
        return len(self.entries)

    def __iter__(self):
        return iter(self.entries)


def read_fof(run_dir: str) -> Fof:
    return Fof.parse(os.path.join(run_dir, "kmtricks.fof"))


# ---------------------------------------------------------------------------
# common header
# ---------------------------------------------------------------------------

def _read_header(f) -> dict:
    raw = f.read(13)
    if len(raw) < 13 or raw[:8] != MAGIC:
        raise FormatError("not a kmtricks file (bad magic)")
    version = struct.unpack_from("<I", raw, 8)[0]
    compressed = raw[12]
    ftype = f.read(8).rstrip(b"\x00").decode()
    return {"version": version, "compressed": bool(compressed), "type": ftype}


def _write_header(f, ftype: str, compressed: bool, version: int = 0):
    f.write(MAGIC)
    f.write(struct.pack("<I", version))
    f.write(bytes([1 if compressed else 0]))
    f.write(ftype.encode().ljust(8, b"\x00"))


# ---------------------------------------------------------------------------
# kmer count files
# ---------------------------------------------------------------------------

_COUNT_DTYPES = {1: np.uint8, 2: np.uint16, 4: np.uint32}


def count_dtype_for(max_count: int):
    """kmtricks selectC analogue: smallest count dtype holding max_count
    (reference compile flag MAX_C, CMakeLists.txt:68-70)."""
    if max_count <= 0xFF:
        return np.uint8
    if max_count <= 0xFFFF:
        return np.uint16
    return np.uint32


@dataclass
class KmerFileInfo:
    kmer_size: int
    count_slots: int
    count_bytes: int
    sample_idx: int
    partition: int
    compressed: bool


def _decode_records(payload, nw: int, cbytes: int, slots: int, path: str):
    """Record payload -> (kmers [n, nw] u64, counts [n, slots] u32): one
    native pass when the extension is built, numpy strided copies otherwise."""
    if cbytes not in _COUNT_DTYPES:
        raise FormatError(f"{path}: unsupported count width {cbytes}")
    if slots <= 0 or not (1 <= nw <= 4):
        raise FormatError(f"{path}: bad record layout (nw={nw}, slots={slots})")
    rec = nw * 8 + cbytes * slots
    if len(payload) % rec:
        raise FormatError(
            f"{path}: payload size {len(payload)} not multiple of {rec}"
        )
    n = len(payload) // rec
    if native.available():
        kmers, counts = native.split_kmer_records(
            np.frombuffer(payload, dtype=np.uint8), n, nw, cbytes, slots
        )
        return kmers, counts
    raw = np.frombuffer(payload, dtype=np.uint8).reshape(n, rec)
    kmers = raw[:, : nw * 8].copy().view("<u8").reshape(n, nw)
    cdt = _COUNT_DTYPES[cbytes]
    counts = (
        raw[:, nw * 8 :]
        .copy()
        .view(np.dtype(cdt).newbyteorder("<"))
        .reshape(n, slots)
        .astype(np.uint32)
    )
    return kmers, (counts[:, 0] if slots == 1 else counts)


def _encode_records(kmers: np.ndarray, counts: np.ndarray, cbytes: int):
    """(kmers, counts) -> record payload (uint8 array / bytes)."""
    if native.available():
        return native.pack_kmer_records(kmers, counts, cbytes)
    n, nw = kmers.shape
    slots = 1 if counts.ndim == 1 else counts.shape[1]
    cdt = _COUNT_DTYPES[cbytes]
    rec = np.zeros((n, nw * 8 + cbytes * slots), dtype=np.uint8)
    rec[:, : nw * 8] = (
        np.ascontiguousarray(kmers.astype("<u8")).view(np.uint8).reshape(n, nw * 8)
    )
    rec[:, nw * 8 :] = (
        np.ascontiguousarray(counts.astype(np.dtype(cdt).newbyteorder("<")))
        .view(np.uint8)
        .reshape(n, cbytes * slots)
    )
    return rec.reshape(-1)


def _write_frame(f, payload, lz4_mode: str):
    """Write payload as one LZ4 frame: single native dispatch when built,
    streaming Python writer otherwise."""
    if native.available():
        f.write(native.lz4_frame_compress(payload, mode=lz4_mode))
        return
    data = payload.tobytes() if isinstance(payload, np.ndarray) else payload
    with Lz4FrameWriter(f, mode=lz4_mode) as w:
        w.write(data)


def read_kmer_file(path: str) -> tuple[KmerFileInfo, np.ndarray, np.ndarray]:
    """Read a sorted per-partition per-sample count file.

    Returns (info, kmers [n, n_words] uint64, counts [n] uint32).
    """
    with open(path, "rb") as f:
        head = _read_header(f)
        if head["type"] != "kmer":
            raise FormatError(f"{path}: expected kmer file, got {head['type']}")
        ksize, slots, cbytes, sidx, part = struct.unpack("<IIIII", f.read(20))
        info = KmerFileInfo(ksize, slots, cbytes, sidx, part, head["compressed"])
        payload = frame_read_all(f) if head["compressed"] else f.read()
    nw = n_words(ksize)
    kmers, counts = _decode_records(
        payload, nw, info.count_bytes, info.count_slots, path
    )
    return info, kmers, counts


def write_kmer_file(
    path: str,
    kmers: np.ndarray,
    counts: np.ndarray,
    kmer_size: int,
    sample_idx: int,
    partition: int,
    count_bytes: int = 4,
    compressed: bool = True,
    lz4_mode: str = "fast",
) -> None:
    """Write a kmtricks-compatible sorted count file. `kmers` must already be
    lexicographically sorted [n, n_words] uint64."""
    nw = n_words(kmer_size)
    assert kmers.ndim == 2 and kmers.shape[1] == nw
    payload = _encode_records(kmers, counts, count_bytes)
    with open(path, "wb") as f:
        _write_header(f, "kmer", compressed)
        f.write(struct.pack("<IIIII", kmer_size, 1, count_bytes, sample_idx, partition))
        if compressed:
            _write_frame(f, payload, lz4_mode)
        else:
            f.write(payload.tobytes() if isinstance(payload, np.ndarray) else payload)


# ---------------------------------------------------------------------------
# histogram files
# ---------------------------------------------------------------------------

@dataclass
class Histogram:
    idx: int
    lower: int
    upper: int
    unique: int
    total: int  # total k-mer mass: sum over distinct k-mers of their count
    oversize_unique: int
    oversize_total: int
    unique_per_bin: np.ndarray  # [upper-lower+1] distinct k-mers per count bin
    total_per_bin: np.ndarray  # [upper-lower+1] mass per count bin
    kmer_size: int = 0


def read_hist(path: str) -> Histogram:
    with open(path, "rb") as f:
        head = _read_header(f)
        if head["type"] != "khist":
            raise FormatError(f"{path}: expected khist file, got {head['type']}")
        ksize, idx = struct.unpack("<II", f.read(8))
        lower, upper, uniq, total, ov_u, ov_t, _r1, _r2 = struct.unpack(
            "<QQQQQQQQ", f.read(64)
        )
        nbins = upper - lower + 1
        uvec = np.frombuffer(f.read(nbins * 8), dtype="<u8").copy()
        tvec = np.frombuffer(f.read(nbins * 8), dtype="<u8").copy()
    return Histogram(idx, lower, upper, uniq, total, ov_u, ov_t, uvec, tvec, ksize)


def write_hist(path: str, h: Histogram) -> None:
    with open(path, "wb") as f:
        _write_header(f, "khist", compressed=False)
        f.write(struct.pack("<II", h.kmer_size, h.idx))
        f.write(
            struct.pack(
                "<QQQQQQQQ",
                h.lower,
                h.upper,
                h.unique,
                h.total,
                h.oversize_unique,
                h.oversize_total,
                0,
                0,
            )
        )
        f.write(h.unique_per_bin.astype("<u8").tobytes())
        f.write(h.total_per_bin.astype("<u8").tobytes())


def hist_from_counts(
    counts: np.ndarray, idx: int, kmer_size: int, lower: int = 1, upper: int = 255
) -> Histogram:
    """Build the per-sample abundance histogram from distinct-k-mer counts."""
    nbins = upper - lower + 1
    # no full-width temporaries beyond one int64 selection: in-range rows
    # bincount directly (their clipped bin is just value - lower)
    inside = (counts >= lower) & (counts <= upper)
    sel = counts[inside].astype(np.int64) - lower
    uvec = np.bincount(sel, minlength=nbins).astype(np.uint64)
    tvec = np.bincount(
        sel, weights=(sel + lower).astype(np.float64), minlength=nbins
    ).astype(np.uint64)
    over = counts > upper
    return Histogram(
        idx=idx,
        lower=lower,
        upper=upper,
        unique=int(counts.size),
        total=int(counts.sum()),
        oversize_unique=int(over.sum()),
        oversize_total=int(counts[over].sum()),
        unique_per_bin=uvec,
        total_per_bin=tvec,
        kmer_size=kmer_size,
    )


def hist_from_device(
    uvec: np.ndarray, total: int, unique: int, idx: int, kmer_size: int,
    lower: int = 1, upper: int = 255,
) -> Histogram:
    """Build the per-sample abundance histogram from a DEVICE-computed
    abundance-cardinality vector instead of the full distinct-count array
    (which the fused pipeline never transfers to host).

    uvec: [257] i32 from ops.codec.sort_rle_core(with_hist=True) —
    uvec[b] = number of distinct k-mers with count b for b in 1..255,
    uvec[256] = number with count > 255 (uvec[0] is pad junk).
    total: exact total counted k-mer mass (sum of all counts = valid
    windows, accumulated on host from the kernels' n_valid stats).
    unique: pre-filter distinct count. Identical bytes to
    hist_from_counts on the same stream: every in-range bin's total mass
    is bin_value * cardinality, and the oversize mass is the exact
    remainder."""
    if upper - lower + 1 != 255 or lower != 1:
        raise ValueError("hist_from_device covers the default 1..255 bins")
    uvec = np.asarray(uvec, dtype=np.uint64)
    unique_per_bin = uvec[1:256].copy()
    total_per_bin = unique_per_bin * np.arange(1, 256, dtype=np.uint64)
    oversize_unique = int(uvec[256])
    oversize_total = int(total) - int(total_per_bin.sum())
    return Histogram(
        idx=idx,
        lower=lower,
        upper=upper,
        unique=int(unique),
        total=int(total),
        oversize_unique=oversize_unique,
        oversize_total=oversize_total,
        unique_per_bin=unique_per_bin,
        total_per_bin=total_per_bin,
        kmer_size=kmer_size,
    )


# ---------------------------------------------------------------------------
# run-dir level helpers (reference parity)
# ---------------------------------------------------------------------------

def get_hist_path(run_dir: str, sample_id: str) -> str:
    return os.path.join(run_dir, "histograms", f"{sample_id}.hist")


def get_total_kmer(
    run_dir: str, nb_controls: int, nb_cases: int, abundance_min: int
) -> tuple[list[int], list[int]]:
    """Per-sample total k-mer counts from histograms, subtracting the mass
    below each sample's abundance-min (reference: src/kmtricks_utils.cpp:78-139:
    total -= j * unique_bin[j-1] for j in [1, ab_min))."""
    fof = read_fof(run_dir)
    totals = []
    for i in range(nb_controls + nb_cases):
        sid = fof.get_id(i)
        h = read_hist(get_hist_path(run_dir, sid))
        ab_min = fof.entries[i].ab_min or abundance_min
        total = h.total
        for j in range(1, ab_min):
            total -= j * int(h.unique_per_bin[j - 1])
        totals.append(total)
    return totals[:nb_controls], totals[nb_controls:]


def get_partition_paths(run_dir: str, nb_parts: int) -> list[list[str]]:
    """Per-partition list of per-sample count files, in fof order
    (reference: src/kmtricks_utils.cpp:142-151 via km::KmDir)."""
    fof = read_fof(run_dir)
    out = []
    for p in range(nb_parts):
        pdir = os.path.join(run_dir, "counts", f"partition_{p}")
        out.append([os.path.join(pdir, f"{e.id}.kmer.lz4") for e in fof])
    return out


def get_matrix_paths(run_dir: str) -> list[str]:
    """Prebuilt count-matrix files if the run dir has them
    (reference: diff.hpp:80-101 scans the matrix storage dir)."""
    mdir = os.path.join(run_dir, "matrices")
    if not os.path.isdir(mdir):
        return []
    return sorted(
        os.path.join(mdir, x) for x in os.listdir(mdir) if x.endswith(".count.lz4")
    )


# ---------------------------------------------------------------------------
# count-matrix files (kmer rows x sample counts); used by --save-sk and by
# the matrix streaming path (reference: merge.hpp:180-207 matrix_proxy,
# km::MatrixWriter). Header mirrors the kmer file with type "matrix" and the
# slot count equal to the number of samples.
# ---------------------------------------------------------------------------

#: decoded rows per streamed matrix block; env knob so tests can force tiny
#: blocks through the streaming path
MATRIX_STREAM_ROWS = int(os.environ.get("KMDIFF_MATRIX_STREAM_ROWS", 1 << 21))


def open_matrix_stream(
    path: str, rows_per_block: int | None = None
) -> tuple[KmerFileInfo, "object"]:
    """Constant-memory matrix reader: (info, generator of (kmers, counts)
    blocks of ≤ rows_per_block rows, in file order).

    The reference streams prebuilt matrices row-by-row through
    km::MatrixReader (matrix_proxy, merge.hpp:319-432) precisely so
    billion-row matrices never materialize; this is the block equivalent —
    the LZ4 frame decodes block-by-block (linked frames ride the native
    continue-decoder's 64 KiB window) and records are sliced off a bounded
    carry buffer.
    """
    rows = rows_per_block or MATRIX_STREAM_ROWS
    f = open(path, "rb")
    try:
        head = _read_header(f)
        if head["type"] not in ("matrix", "kmer"):
            raise FormatError(f"{path}: expected matrix file, got {head['type']}")
        ksize, slots, cbytes, sidx, part = struct.unpack("<IIIII", f.read(20))
        info = KmerFileInfo(ksize, slots, cbytes, sidx, part, head["compressed"])
        nw = n_words(ksize)
        if cbytes not in _COUNT_DTYPES or slots <= 0 or not (1 <= nw <= 4):
            raise FormatError(f"{path}: bad record layout")
    except BaseException:
        f.close()
        raise
    rec = nw * 8 + cbytes * slots

    def blocks():
        try:
            src = Lz4FrameReader(f) if info.compressed else f
            pending = b""
            while True:
                want = rows * rec - len(pending)
                data = src.read(want)
                buf = pending + data
                n = len(buf) // rec
                pending = buf[n * rec :]
                if n:
                    kmers, counts = _decode_records(
                        buf[: n * rec], nw, cbytes, slots, path
                    )
                    yield kmers, counts.reshape(n, slots)
                if len(data) < want:  # EOF
                    if pending:
                        raise FormatError(
                            f"{path}: trailing {len(pending)} bytes are not "
                            f"a whole record"
                        )
                    return
        finally:
            f.close()

    return info, blocks()


def write_matrix_file(
    path: str,
    kmers: np.ndarray,
    counts: np.ndarray,
    kmer_size: int,
    partition: int,
    count_bytes: int = 4,
    compressed: bool = True,
    lz4_mode: str = "fast",
) -> None:
    nw = n_words(kmer_size)
    n, nsamples = counts.shape
    payload = _encode_records(kmers, counts, count_bytes)
    with open(path, "wb") as f:
        _write_header(f, "matrix", compressed)
        f.write(struct.pack("<IIIII", kmer_size, nsamples, count_bytes, 0, partition))
        if compressed:
            _write_frame(f, payload, lz4_mode)
        else:
            f.write(payload.tobytes() if isinstance(payload, np.ndarray) else payload)
