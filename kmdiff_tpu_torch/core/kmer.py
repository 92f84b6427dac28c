"""Host-side (numpy) 2-bit k-mer codec.

Encoding follows kmtricks: code = (ascii >> 1) & 3, i.e. A=0, C=1, T=2, G=3
(the same encoding the reference writes into KFF headers as {A:0,C:1,G:3,T:2},
reference: include/kmdiff/kff_utils.hpp:39,74-84). Complement is code ^ 2.

k-mers pack into ceil(k/32) uint64 words; the FIRST nucleotide of the k-mer
occupies the HIGHEST-order bits of the first word, so integer comparison of
the packed words gives lexicographic order over the encoded alphabet —
matching the sortedness of kmtricks partition files.

The device-side codec (int64 keys, K-EXT) lives in ops.codec.
"""

from __future__ import annotations

import numpy as np

# ascii -> 2-bit code; valid for upper/lowercase ACGT; anything else maps to
# code 4 via the VALID table used to mask windows containing N etc.
_CODE = np.zeros(256, dtype=np.uint8)
_VALID = np.zeros(256, dtype=bool)
for _c in b"ACGTacgt":
    _CODE[_c] = (_c >> 1) & 3
    _VALID[_c] = True

_DECODE = np.frombuffer(b"ACTG", dtype=np.uint8)  # index by 2-bit code

# number of uint64 words needed for k
def n_words(k: int) -> int:
    return (k + 31) // 32


def encode_bases(seq_bytes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """ascii uint8 array -> (codes uint8, valid bool)."""
    return _CODE[seq_bytes], _VALID[seq_bytes]


def seq_to_codes(seq: str | bytes) -> tuple[np.ndarray, np.ndarray]:
    if isinstance(seq, str):
        seq = seq.encode()
    arr = np.frombuffer(seq, dtype=np.uint8)
    return encode_bases(arr)


def kmers_from_codes(codes: np.ndarray, valid: np.ndarray, k: int) -> np.ndarray:
    """All k-length windows of a code sequence packed into uint64 words.

    Returns an array of shape [n_kmers, n_words(k)]; windows containing an
    invalid base are dropped. For k <= 32 the single word holds the k-mer in
    its low 2k bits, first base highest.
    """
    L = len(codes)
    if L < k:
        return np.zeros((0, n_words(k)), dtype=np.uint64)
    win = np.lib.stride_tricks.sliding_window_view(codes, k)  # [n, k]
    okwin = np.lib.stride_tricks.sliding_window_view(valid, k).all(axis=1)
    win = win[okwin].astype(np.uint64)
    return pack_codes(win, k)


def pack_codes(win: np.ndarray, k: int) -> np.ndarray:
    """[n, k] 2-bit codes -> [n, n_words] packed uint64 (first base highest
    within each 32-base word; word 0 holds bases 0..31, word 1 bases 32..63...
    with the LAST word right-aligned so that lexicographic == numeric order
    requires full words; we left-align instead: see below).

    Layout choice: bases are packed 32 per word, first word first. The final
    partial word keeps its bases in its LOW bits (matching kmtricks' Kmer
    storage where a k=20 k-mer occupies the low 40 bits of one uint64).
    """
    n, kk = win.shape
    assert kk == k
    nw = n_words(k)
    out = np.zeros((n, nw), dtype=np.uint64)
    for w in range(nw):
        lo = w * 32
        hi = min(k, lo + 32)
        width = hi - lo
        shifts = np.arange(width - 1, -1, -1, dtype=np.uint64) * np.uint64(2)
        out[:, w] = (win[:, lo:hi] << shifts[None, :]).sum(
            axis=1, dtype=np.uint64
        )
    return out


def unpack_codes(packed: np.ndarray, k: int) -> np.ndarray:
    """[n, n_words] packed uint64 -> [n, k] 2-bit codes."""
    n = packed.shape[0]
    nw = n_words(k)
    out = np.zeros((n, k), dtype=np.uint8)
    for w in range(nw):
        lo = w * 32
        hi = min(k, lo + 32)
        width = hi - lo
        shifts = np.arange(width - 1, -1, -1, dtype=np.uint64) * np.uint64(2)
        out[:, lo:hi] = ((packed[:, w : w + 1] >> shifts[None, :]) & np.uint64(3)).astype(
            np.uint8
        )
    return out


def revcomp_packed(packed: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement of packed k-mers (via unpack; device path uses
    bit-twiddling — this host version favors clarity)."""
    codes = unpack_codes(packed, k)
    rc = (codes[:, ::-1] ^ 2).astype(np.uint64)
    return pack_codes(rc, k)


def canonical_packed(packed: np.ndarray, k: int) -> np.ndarray:
    """Canonical form: lexicographic min of k-mer and its reverse complement
    under the A<C<T<G encoded order (kmtricks semantics: comparison happens
    on the 2-bit-encoded value, not on ACGT alphabetical order)."""
    rc = revcomp_packed(packed, k)
    fwd_key = packed
    # lexicographic compare over words
    take_rc = np.zeros(len(packed), dtype=bool)
    undecided = np.ones(len(packed), dtype=bool)
    for w in range(packed.shape[1]):
        lt = rc[:, w] < fwd_key[:, w]
        gt = rc[:, w] > fwd_key[:, w]
        take_rc |= undecided & lt
        undecided &= ~(lt | gt)
    out = np.where(take_rc[:, None], rc, fwd_key)
    return out


def packed_to_strings(packed: np.ndarray, k: int) -> list[str]:
    codes = unpack_codes(packed, k)
    chars = _DECODE[codes]
    return [bytes(row).decode() for row in chars]


def string_to_packed(s: str) -> np.ndarray:
    codes, valid = seq_to_codes(s)
    if not valid.all():
        raise ValueError(f"invalid base in k-mer: {s}")
    return pack_codes(codes.astype(np.uint64)[None, :], len(s))[0]


def sort_packed(packed: np.ndarray, *payloads: np.ndarray):
    """Lexicographic sort of packed k-mers (word 0 major); returns sorted
    kmers plus payloads gathered in the same order."""
    order = np.lexsort(tuple(packed[:, w] for w in range(packed.shape[1] - 1, -1, -1)))
    return (packed[order],) + tuple(p[order] for p in payloads)
