"""Eigenstrat PCA of the sampled geno matrix (port of kmdiff_tpu/ops/pca.py).

The normalised Gram of a 0/1 matrix decomposes over its row-sum groups into
integer aggregates (kmdiff_tpu/ops/pca.py's docstring has the algebra):
each group's exact integer Gram G_r comes from K-GRAM on the geno matrix's
device, its column sums and the f64 weights from numpy on the host, and the
S x S eigenproblem is numpy.linalg.eigh in f64 with the JAX package's sign
rule. Since every integer is exact, Z and the eigenvalues are bit-identical
to the JAX package's. Every group runs through K-GRAM, however small: the
JAX package kept small groups on the host because a TPU dispatch was dear.

  K-GRAM int_gram   [B, S] 0/1 uint8 -> [S, S] int64 X^T X, exact at any B
"""

from __future__ import annotations

import numpy as np
import torch

from kmdiff_tpu_torch import kernels


def int_gram_plain(X: torch.Tensor) -> torch.Tensor:
    # f64 products of 0/1 values and sums below 2^53 are exact integers
    Xf = (X != 0).to(torch.float64)
    return (Xf.T @ Xf).to(torch.int64)


def int_gram(X: torch.Tensor) -> torch.Tensor:
    """K-GRAM: X [B, S] uint8 (0/1; any nonzero counts as 1) -> X^T X as
    [S, S] int64. Up to 256 samples, one launch and one device operation:
    the kernel packs the bits and takes the popcounts in one pass, into
    per-block partial sums that it folds behind one grid-wide sync; above,
    a memset, a packing kernel and a tiled popcount kernel. Either form's
    scratch (partial sums or packed bits) comes from torch.empty."""
    if X.device.type == "cpu":
        return int_gram_plain(X)
    kernels.require_cuda_tensor("int_gram X", X, torch.uint8)
    if X.dim() != 2:
        raise ValueError(f"int_gram: expected [B, S], got {tuple(X.shape)}")
    B, S = X.shape
    if not B or not S:
        return torch.zeros((S, S), dtype=torch.int64, device=X.device)
    gram = torch.empty((S, S), dtype=torch.int64, device=X.device)
    with torch.cuda.device(X.device):
        words = kernels.lib().kmd_int_gram_scratch_words(B, S)
        if words < 0:
            raise RuntimeError(f"int_gram: K-GRAM cannot plan [{B}, {S}]")
        scratch = torch.empty(words, dtype=torch.int32, device=X.device)
        kernels.launch("int_gram", "kmd_int_gram", X.data_ptr(), B, S,
                       scratch.data_ptr(), gram.data_ptr())
    return gram


def _int_gram(X01: np.ndarray, mesh) -> np.ndarray:
    """Exact integer Gram of a host 0/1 matrix through K-GRAM, [S, S] f64.
    The rows split into contiguous blocks, one a shard of the mesh
    (parallel.mesh.Mesh), each through K-GRAM on its shard's device, and the
    int64 partials are summed: the sum is exact, so the Gram is the same on
    any mesh (kmdiff_tpu/ops/pca.py:56-110, which shards its f32-exact row
    tiles)."""
    X01 = np.ascontiguousarray(X01, dtype=np.uint8)
    blocks = mesh.blocks(len(X01))
    partials = mesh.map(lambda d, dev: int_gram(torch.from_numpy(
        X01[slice(*blocks[d])]).to(dev)).cpu().numpy(), len(blocks))
    return np.sum(partials, axis=0, dtype=np.int64).astype(np.float64)


def eigenstrat_pca(geno: np.ndarray, device: torch.device,
                   is_diploid: bool = True, n_evec: int = 10
                   ) -> tuple[np.ndarray, np.ndarray]:
    """PCA of a [M, S] 0/1 presence matrix (rows = sampled k-mers).

    Returns (Z [S, n] per-sample principal components, the pcs.evec
    columns, unit-norm; evals [n] descending), bit-identical to
    kmdiff_tpu.ops.pca.eigenstrat_pca: the same host arithmetic in the same
    order around exact integer Grams (over the mesh's shards, with a
    mesh: parallel.runtime)."""
    from kmdiff_tpu_torch.parallel.runtime import get_mesh

    mesh = get_mesh(device)
    M, S = geno.shape
    n_evec = min(n_evec, S)
    if M == 0:
        return np.zeros((S, n_evec)), np.zeros(n_evec)

    r = geno.sum(axis=1, dtype=np.int64)  # row sums, 0..S
    order = np.argsort(r, kind="stable")
    r_sorted = r[order]
    uniq, starts = np.unique(r_sorted, return_index=True)
    bounds = np.append(starts, M)

    ones = np.ones(S, dtype=np.float64)
    J = np.outer(ones, ones)
    gram = np.zeros((S, S), dtype=np.float64)
    for gi, rv in enumerate(uniq):
        a, b = int(bounds[gi]), int(bounds[gi + 1])
        idx = order[a:b]
        Xg = np.ascontiguousarray(geno[idx])
        G = _int_gram(Xg, mesh)                          # exact integers
        C = Xg.sum(axis=0, dtype=np.int64).astype(np.float64)
        n_g = float(b - a)
        m = float(rv) / S
        if is_diploid:
            p = 1.0 - np.sqrt(max(1.0 - m, 0.0))
        else:
            p = m
        var = p * (1.0 - p)
        s2 = 1.0 / max(var, 1e-30) if var > 0.0 else 1.0
        gram += s2 * (G - m * (np.outer(C, ones) + np.outer(ones, C))
                      + (m * m * n_g) * J)

    evals, evecs = np.linalg.eigh(gram / M)
    order_e = np.argsort(evals)[::-1][:n_evec]
    evals = evals[order_e]
    Z = evecs[:, order_e]
    # deterministic sign: largest-|component| entry positive
    for j in range(Z.shape[1]):
        k = np.argmax(np.abs(Z[:, j]))
        if Z[k, j] < 0:
            Z[:, j] = -Z[:, j]
    return Z, evals
