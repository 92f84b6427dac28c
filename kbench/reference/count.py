"""Canonical k-mer counting and the cohort merge, in plain PyTorch.

A k-mer's bases are coded as kmtricks codes them, A=0, C=1, T=2, G=3, so
that the complement of a code is the code XOR 2, and it is packed 32 bases
a 64-bit word, first base highest, the last word holding its bases in its
low bits. Its canonical form is the smaller, base by base in that code
order, of the k-mer and its reverse complement: the form kmtricks counts
and kmdiff writes.

Keys here are [nw, N] int64, one row a word, each word XORed with 1<<63 so
that signed order is the words' unsigned order. Every read is a run of
valid bases (the cohort writes A, C, G and T alone), and a k-mer never
spans two reads.
"""

from __future__ import annotations

import numpy as np
import torch

_SIGN = -(1 << 63)
#: ascii -> code; other bytes are not expected in the reads
_LUT = np.zeros(256, dtype=np.int64)
for _b, _c in zip(b"ACTGactg", (0, 1, 2, 3, 0, 1, 2, 3)):
    _LUT[_b] = _c
_DECODE = np.frombuffer(b"ACTG", dtype=np.uint8)


def n_words(k: int) -> int:
    return (k + 31) // 32


def _words(codes: torch.Tensor, k: int, first: int, step: int, flip: int):
    """The packed words of every window: base j of the k-mer is
    codes[:, first + step * j] ^ flip."""
    W = codes.shape[1] - k + 1
    out = []
    for lo in range(0, k, 32):
        acc = torch.zeros((codes.shape[0], W), dtype=torch.int64, device=codes.device)
        for j in range(lo, min(k, lo + 32)):
            col = first + step * j
            acc = (acc << 2) | (codes[:, col:col + W] ^ flip)
        out.append(acc.reshape(-1) ^ _SIGN)
    return torch.stack(out)


def canonical_keys(reads: np.ndarray, k: int, device) -> torch.Tensor:
    """[n, L] ascii reads -> [nw, n (L - k + 1)] canonical keys."""
    lut = torch.from_numpy(_LUT).to(device)
    codes = lut[torch.from_numpy(np.ascontiguousarray(reads)).to(device).long()]
    fw = _words(codes, k, 0, 1, 0)
    rc = _words(codes, k, k - 1, -1, 2)
    return torch.where(_lex_le(fw, rc), fw, rc)


def _lex_le(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a[:, i] <= b[:, i] lexicographically over the rows."""
    le = a[-1] <= b[-1]
    for w in range(a.shape[0] - 2, -1, -1):
        le = (a[w] < b[w]) | ((a[w] == b[w]) & le)
    return le


def sort_keys(keys: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts [nw, N] keys lexicographically (stable
    passes from the last word to the first)."""
    perm = torch.arange(keys.shape[1], device=keys.device)
    for w in range(keys.shape[0] - 1, -1, -1):
        perm = perm[torch.sort(keys[w][perm], stable=True).indices]
    return perm


def _runs(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Start of each run of equal keys in sorted [nw, N] keys."""
    new = torch.ones(sorted_keys.shape[1], dtype=torch.bool, device=sorted_keys.device)
    if sorted_keys.shape[1] > 1:
        new[1:] = (sorted_keys[:, 1:] != sorted_keys[:, :-1]).any(dim=0)
    return torch.nonzero(new).squeeze(1)


def count(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[nw, N] keys -> (distinct keys [nw, U] ascending, counts [U] int64)."""
    s = keys[:, sort_keys(keys)]
    starts = _runs(s)
    ends = torch.cat([starts[1:], torch.tensor([s.shape[1]], device=s.device)])
    return s[:, starts], ends - starts


def histogram(counts: torch.Tensor) -> dict:
    """The abundance histogram of one sample's counts (bins 1..255, and
    what lies above 255), as kmtricks defines it."""
    c = counts.cpu().numpy().astype(np.int64)
    over = c > 255
    uvec = np.bincount(c[~over], minlength=256)[1:256]
    return {"unique": int(c.size), "total": int(c.sum()),
            "oversize_unique": int(over.sum()), "oversize_total": int(c[over].sum()),
            "unique_per_bin": uvec, "total_per_bin": uvec * np.arange(1, 256)}


def group_sums(samples: list[tuple[torch.Tensor, torch.Tensor]], nb_controls: int):
    """Union of the samples' distinct keys -> (keys [nw, U], control sums,
    case sums [U] int64); samples before nb_controls are controls."""
    keys = torch.cat([k for k, _ in samples], dim=1)
    ctrl = torch.cat([c if i < nb_controls else torch.zeros_like(c)
                      for i, (_, c) in enumerate(samples)])
    case = torch.cat([torch.zeros_like(c) if i < nb_controls else c
                      for i, (_, c) in enumerate(samples)])
    perm = sort_keys(keys)
    keys = keys[:, perm]
    starts = _runs(keys)
    run = torch.zeros(keys.shape[1], dtype=torch.int64, device=keys.device)
    run[starts] = 1
    run = torch.cumsum(run, 0) - 1
    U = starts.numel()
    s_c = torch.zeros(U, dtype=torch.int64, device=run.device).index_add_(0, run, ctrl[perm])
    s_k = torch.zeros(U, dtype=torch.int64, device=run.device).index_add_(0, run, case[perm])
    return keys[:, starts], s_c, s_k


def to_strings(keys: torch.Tensor, k: int) -> list[str]:
    """[nw, H] keys -> the k-mers as strings."""
    words = (keys.cpu().numpy() ^ np.int64(_SIGN)).view(np.uint64)
    codes = np.empty((words.shape[1], k), dtype=np.uint8)
    for w, lo in enumerate(range(0, k, 32)):
        width = min(k, lo + 32) - lo
        for j in range(width):
            shift = np.uint64(2 * (width - 1 - j))
            codes[:, lo + j] = (words[w] >> shift) & np.uint64(3)
    text = _DECODE[codes]
    return [row.tobytes().decode() for row in text]
