"""The plain reference of popstrat (``diff --pop-correction``): the
Eigenstrat PCA of a hashed sample of k-mers and a logistic likelihood-ratio
test for every k-mer that passes the merge, then the correction.

Plain PyTorch in float64 (TF32 off), from the per-sample sorted keys and
counts that ``reference.count`` makes of the benchmark's own FASTA files.
It imports neither JAX nor the JAX package nor anything of the port, and
takes nothing that the program made. Upstream's semantics (kmdiff,
include/kmdiff/popstrat.hpp, src/popstrat.cpp), as the port's
``pipeline/popstrat.py`` and ``ops/pca.py`` document them:

1. The genotype sample. Every distinct k-mer of the cohort's union (after
   hard-min) whose hash falls below ``kmer_pca * (2^32 - 1)``: the hash
   starts at ``0x51ED2700 ^ random_seed`` (kmdiff's ``--random-seed``, 0 by
   default: ``RANDOM_SEED``) and takes murmur3's fmix32 of
   itself XOR each word's high half, then of itself XOR its low half, most
   significant word first, on the k-mer's packed words. A row holds each
   sample's presence (count > 0).
2. The Eigenstrat PCA (smartpca's normalisation): each row x with mean m
   over the S samples, p = 1 - sqrt(1 - m) (ploidy 2, kmdiff's default
   ``--ploidy``: ``DIPLOID``), is scaled to
   (x - m) / sqrt(p (1 - p)) (by 1 where p (1 - p) is 0); the S x S Gram
   over the M rows, divided by M, its eigh, and the top ``n_pc``
   eigenvectors.
3. The survivors: the k-mers whose Poisson p-value (reference.score, f64)
   is at most ``significance / cutoff``, with their per-sample counts
   (looked up in each sample's sorted keys) and each sample's total (its
   histogram's mass above hard-min).
4. The fits: label 1 for a control, 0 for a case; the null design
   [1 | PCs | totals], the alt design the same and the k-mer's count over
   the sample's total. LLR = 2 (ll_alt - ll_null), its chi-square (1 df)
   survival function the p-value.
5. The correction (``accept``): kmdiff's ``disabled`` (p < significance),
   ``bonferroni`` or its sequential Benjamini-Hochberg walk over the
   ascending p-values (the rank advances on each acceptance, the walk
   stops at the first rejection), against the k-mers tested; the sign and
   the means are the Poisson test's.

Departures from upstream, none of which changes a p-value:

- The fits run on an orthonormal basis of each design's column space
  (an SVD; directions under 1e-9 of the largest dropped), not on the raw
  columns. The likelihood ratio depends on the column space alone: any
  invertible linear change of the columns (the intercept included; sign
  flips and rotations of the PCs) leaves it as it is, so the PCs are
  never compared, only p-values. This also keeps a design whose totals
  are equal (a constant column) or mix ~1e7 totals with ~1e-7 ratios
  solvable in f64.
- Newton's method from zero weights, each step halved while it lowers the
  log-likelihood (at most 30 times), until |delta ll| < 1e-10 or 100
  iterations; upstream runs IRLS with its own stop rule. A fit in which a
  fitted probability comes within 1e-9 of 0 or 1 is quasi-separated: its
  likelihood has no maximum, and its p-value depends on where a solver
  stops, so the comparison gives it a wider band (``SEP_BAND``).
- The genotype rows come in key order, not partition by partition: the
  Gram is a sum over rows, and does not depend on their order.
- Upstream's ``std::uniform`` draw per k-mer gives way to the hash, as in
  the port (reproducible whatever the thread order).
"""

from __future__ import annotations

import dataclasses

import torch

from kbench.reference import count, score

_U32 = 0xFFFFFFFF
_SAMPLE_SEED = 0x51ED2700
#: kmdiff's defaults, which every benchmarked job keeps: ``--random-seed 0``,
#: ``--ploidy 2``
RANDOM_SEED = 0
DIPLOID = True
_SIGN = -(1 << 63)
#: a fitted probability this close to 0 or 1 marks a quasi-separated fit
SEPARATED = 1e-9
#: the relative band around each reference p-value within which a written
#: one agrees: f32 fits against f64, and quasi-separated fits, whose p
#: depends on where a solver stops (PERF.md gives the readings)
BAND = 0.01
SEP_BAND = 0.25
#: Newton's stop rule and bound
LL_TOL = 1e-10
MAX_ITERS = 100
#: a direction of a design under this share of its largest singular value
#: is not in its column space
RANK_TOL = 1e-9


@dataclasses.dataclass
class PopFit:
    """Every survivor's popstrat p-value, and the PCA behind them."""

    p: torch.Tensor
    edge: torch.Tensor
    eigvals: torch.Tensor
    n_geno: int

    @property
    def separated(self) -> torch.Tensor:
        return self.edge < SEPARATED

    @property
    def band(self) -> torch.Tensor:
        """Each p-value's relative band (BAND, or SEP_BAND where separated)."""
        return torch.where(self.separated, SEP_BAND, BAND).to(self.p.dtype)

    def eig_gap(self, n_pc: int) -> float:
        """(lambda_npc - lambda_npc+1) / lambda_npc."""
        a, b = float(self.eigvals[n_pc - 1]), float(self.eigvals[n_pc])
        return (a - b) / a if a > 0 else 0.0


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """h * m mod 2^32 for h < 2^32 in int64, in 16-bit halves of m so that
    no product passes 2^63."""
    lo = h * (m & 0xFFFF)
    hi = ((h * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def sample_mask(keys: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """[nw, N] keys (each word XORed with 1 << 63, reference.count's form)
    -> [N] bool: the k-mers the genotype sample keeps."""
    h = torch.full_like(keys[0], (_SAMPLE_SEED ^ seed) & _U32)
    for word in keys:
        raw = word ^ _SIGN
        h = _fmix32(h ^ ((raw >> 32) & _U32))
        h = _fmix32(h ^ (raw & _U32))
    return h < int(min(rate, 1.0) * 4294967295.0)


def lookup(keys: torch.Tensor, counts: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """One sample's count of each query k-mer, 0 where it has none: keys
    [nw, N] sorted and distinct, counts [N], query [nw, Q] -> [Q] int64.
    One word: torch.searchsorted; more: the lexicographic search as a
    stable sort of keys and queries together, each query right after its
    key where the sample has it."""
    if keys.shape[1] == 0:
        return torch.zeros(query.shape[1], dtype=torch.int64, device=query.device)
    if keys.shape[0] == 1:
        at = torch.searchsorted(keys[0].contiguous(), query[0]).clamp_(max=keys.shape[1] - 1)
        return torch.where(keys[0][at] == query[0], counts[at], 0)
    n = keys.shape[1]
    both = torch.cat([keys, query], dim=1)
    perm = count.sort_keys(both)
    s = both[:, perm]
    out = torch.zeros(query.shape[1], dtype=torch.int64, device=query.device)
    is_q = perm >= n
    is_q[0] = False
    j = torch.nonzero(is_q).squeeze(1)
    hit = (perm[j - 1] < n) & (s[:, j] == s[:, j - 1]).all(dim=0)
    out[perm[j[hit]] - n] = counts[perm[j[hit] - 1]]
    return out


def count_rows(samples: list, query: torch.Tensor) -> torch.Tensor:
    """[Q, S] int64: each sample's count of each query k-mer."""
    return torch.stack([lookup(k, c, query) for k, c in samples], dim=1)


def eigenstrat(geno: torch.Tensor, n_pc: int, diploid: bool):
    """[M, S] 0/1 -> (PCs [S, n_pc], eigenvalues [S] descending), f64."""
    x = geno.to(torch.float64)
    m = x.mean(dim=1, keepdim=True)
    p = 1.0 - torch.sqrt(torch.clamp(1.0 - m, min=0.0)) if diploid else m
    var = p * (1.0 - p)
    scale = torch.where(var > 0, 1.0 / torch.sqrt(torch.where(var > 0, var, 1.0)), 1.0)
    xn = (x - m) * scale
    gram = xn.T @ xn / max(x.shape[0], 1)
    vals, vecs = torch.linalg.eigh(gram)
    order = torch.argsort(vals, descending=True)
    return vecs[:, order[:n_pc]], vals[order]


def _basis(x: torch.Tensor) -> torch.Tensor:
    """[n, F] with the intercept first -> an orthonormal basis [n, r] of
    its column space: the other columns centred and scaled to unit norm (a
    constant one becomes 0), then an SVD."""
    x = torch.cat([x[:, :1], x[:, 1:] - x[:, 1:].mean(dim=0)], dim=1)
    norm = torch.linalg.vector_norm(x, dim=0)
    x = x / torch.where(norm > 0, norm, 1.0)
    u, sv, _ = torch.linalg.svd(x, full_matrices=False)
    return u[:, sv > RANK_TOL * sv[0]]


def _loglik(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bernoulli log-likelihood of logits z [B, n] under labels y [n]."""
    return -(y * torch.nn.functional.softplus(-z)
             + (1.0 - y) * torch.nn.functional.softplus(z)).sum(dim=1)


def newton(x: torch.Tensor, y: torch.Tensor, max_iters: int = MAX_ITERS):
    """Logistic fits of B designs x [B, n, F] to labels y [n] by damped
    Newton steps from zero weights -> (w [B, F], ll [B], edge [B]: the
    least distance of a fitted probability from 0 or 1)."""
    B, n, F = x.shape
    w = torch.zeros(B, F, dtype=x.dtype, device=x.device)
    ll = _loglik(torch.zeros(B, n, dtype=x.dtype, device=x.device), y)
    active = torch.ones(B, dtype=torch.bool, device=x.device)
    for _ in range(max_iters):
        if not bool(active.any()):
            break
        z = (x @ w[:, :, None])[:, :, 0]
        mu = torch.sigmoid(z)
        g = ((y - mu)[:, :, None] * x).sum(dim=1)
        h = (x * (mu * (1.0 - mu))[:, :, None]).transpose(1, 2) @ x
        step, info = torch.linalg.solve_ex(h, g)
        ok = active & (info == 0) & torch.isfinite(step).all(dim=1)
        # the step, halved while it lowers the log-likelihood
        t = torch.ones(B, dtype=x.dtype, device=x.device)
        new_ll = ll.clone()
        found = ~ok
        for _ in range(31):
            cand_ll = _loglik((x @ (w + t[:, None] * step)[:, :, None])[:, :, 0], y)
            better = ~found & (cand_ll >= ll)
            new_ll = torch.where(better, cand_ll, new_ll)
            found = found | better
            if bool(found.all()):
                break
            t = torch.where(found, t, t / 2)
        take = ok & found
        w = torch.where(take[:, None], w + t[:, None] * step, w)
        done = ~take | ((new_ll - ll).abs() < LL_TOL)
        ll = torch.where(take, new_ll, ll)
        active = active & ~done
    mu = torch.sigmoid((x @ w[:, :, None])[:, :, 0])
    edge = torch.minimum(mu, 1.0 - mu).min(dim=1).values
    return w, ll, edge


def logistic_lrt(pcs: torch.Tensor, totals: torch.Tensor, ratios: torch.Tensor,
                 y: torch.Tensor, block: int = 4096, storage=None):
    """The null fit on [1 | pcs | totals] and every k-mer's alt fit with its
    ratio column -> (p [H], edge [H]: the least of the null's and the alt
    fit's edge, newton's); the alt designs in blocks of `block` k-mers.
    storage: a dtype that every design column is rounded to and in which
    each fit's log-likelihood is evaluated, from its logits to its sum (the
    bf16 control)."""
    def rnd(t: torch.Tensor) -> torch.Tensor:
        return t if storage is None else t.to(storage).to(t.dtype)

    def loglik(x: torch.Tensor, w: torch.Tensor, ll: torch.Tensor) -> torch.Tensor:
        if storage is None:
            return ll
        z = (x.to(storage) @ w.to(storage)[:, :, None])[:, :, 0]
        return _loglik(z, y.to(storage)).to(ll.dtype)

    n, H = y.shape[0], ratios.shape[0]
    null = rnd(_basis(torch.cat([torch.ones(n, 1, dtype=pcs.dtype, device=pcs.device),
                                 pcs, totals[:, None]], dim=1)))
    w0, ll0, edge0 = newton(null[None], y)
    ll0 = loglik(null[None], w0, ll0)
    p = torch.ones(H, dtype=torch.float64, device=y.device)
    edge = torch.zeros(H, dtype=torch.float64, device=y.device)
    for a in range(0, H, block):
        r = ratios[a:a + block]
        # the ratio column's part outside the null design's space, unit norm;
        # nothing where the ratio lies in that space (the alt is the null)
        r = r - (r @ null) @ null.T
        norm = torch.linalg.vector_norm(r, dim=1, keepdim=True)
        scale = torch.linalg.vector_norm(ratios[a:a + block], dim=1, keepdim=True)
        inside = norm <= RANK_TOL * scale
        r = torch.where(inside, 0.0, r / torch.where(inside, 1.0, norm))
        x = torch.cat([null.expand(r.shape[0], -1, -1), rnd(r)[:, :, None]], dim=2)
        w1, ll1, edge1 = newton(x, y)
        ll1 = loglik(x, w1, ll1)
        llr = torch.where(inside[:, 0], 0.0, torch.clamp(2.0 * (ll1 - ll0), min=0.0))
        p[a:a + block] = torch.special.erfc(torch.sqrt(llr / 2.0))
        edge[a:a + block] = torch.minimum(edge1, edge0)
    return p, edge


def fit(counts, config: dict, survivors: torch.Tensor, storage=None) -> PopFit:
    """Popstrat's p-values of the union rows `survivors` of a counted
    cohort (reference.Counts with its samples kept) under `config`'s
    analysis (``kmer_pca``, ``n_pc``; kmdiff's default seed and ploidy);
    storage: logistic_lrt's."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        sampled = sample_mask(counts.keys, config["kmer_pca"], RANDOM_SEED)
        geno = count_rows(counts.samples, counts.keys[:, sampled]) > 0
        pcs, vals = eigenstrat(geno, config["n_pc"], DIPLOID)
        rows = count_rows(counts.samples, counts.keys[:, survivors]).to(torch.float64)
        totals = torch.tensor(counts.masses, dtype=torch.float64, device=rows.device)
        y = torch.zeros(len(counts.masses), dtype=torch.float64, device=rows.device)
        y[:counts.nb_controls] = 1.0
        p, edge = logistic_lrt(pcs, totals, rows / totals, y, storage=storage)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    return PopFit(p, edge, vals, int(geno.shape[0]))


def accept(p: torch.Tensor, correction: str, alpha: float, n_tested: int) -> torch.Tensor:
    """kmdiff's correction of [H] p-values against the k-mers tested -> [H]
    bool, the k-mers it writes (upstream src/corrector.cpp, every bound a
    strict <): ``disabled`` p < alpha; ``bonferroni`` p < alpha / n; and
    ``benjamini``, a walk over the ascending p-values (a stable order on
    ties) in which the i-th, from 0, passes where p < (i + 1) / n alpha
    (the rank advances on each acceptance) and that stops at the first
    rejection."""
    if correction == "disabled":
        return p < alpha
    if correction == "bonferroni":
        return p < alpha / n_tested
    if correction != "benjamini":
        raise ValueError(f"the popstrat reference knows no correction {correction!r}")
    order = torch.sort(p, stable=True).indices
    rank = torch.arange(1, p.numel() + 1, dtype=torch.float64, device=p.device)
    keep = torch.cumprod((p[order] < rank / n_tested * alpha).to(torch.int64), 0).bool()
    out = torch.zeros_like(keep)
    out[order] = keep
    return out


def poisson_survivors(counts, config: dict):
    """The rows of the union that pass the merge (Poisson p <= significance
    / cutoff, f64) -> (rows [H], p, sign, mean_control, mean_case)."""
    p, sign, mc, mk = score.score(counts.s_c, counts.s_k, counts.t_c, counts.t_k,
                                  torch.float64)
    hit = torch.nonzero(p <= config["significance"] / config["cutoff"]).squeeze(1)
    return hit, p[hit], sign[hit], mc[hit], mk[hit]
