"""The HAWK Poisson likelihood-ratio test, kmdiff's sign rule and its
Bonferroni correction, in plain PyTorch.

Per k-mer, with control and case count sums sC and sK and the groups' k-mer
masses Tc and Tk (HAWK, Rahman et al. 2018; kmdiff's PoissonLikelihood):

  mu   = (sC + sK) / (Tc + Tk)
  alt  = P(sC; sC) + P(sK; sK),  null = P(sC; mu Tc) + P(sK; mu Tk)
  P(k; lam) = -lam + k log(lam) - log(k!), and 0 where lam <= 0
  LR   = max(alt - null, 0),  p = chi2_sf(2 LR, 1) = erfc(sqrt(LR))
  sign = control where sC Tk / Tc > sK, case where <, none where equal

A k-mer is reported where p <= alpha / cutoff (kmdiff's merge filter) and
p < alpha / N (Bonferroni over the N k-mers tested). kmdiff computes in
double: ``dtype=torch.float64`` is the reference, in which the sign rule is
taken exactly in integers. ``torch.float32`` is the control: the same
arithmetic one precision lower, the sign rule included.
"""

from __future__ import annotations

import torch


def _log_poisson(k: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    val = -lam + k * torch.log(lam) - torch.lgamma(k + 1)
    return torch.where(lam > 0, val, torch.zeros_like(val))


def score(s_c: torch.Tensor, s_k: torch.Tensor, t_c: int, t_k: int, dtype):
    """-> (p, sign, mean_control, mean_case), sign 0 control, 1 case, 2 none."""
    fc, fk = s_c.to(dtype), s_k.to(dtype)
    tc = torch.tensor(float(t_c), dtype=dtype, device=fc.device)
    tk = torch.tensor(float(t_k), dtype=dtype, device=fc.device)
    mu = (fc + fk) / (tc + tk)
    alt = _log_poisson(fc, fc) + _log_poisson(fk, fk)
    null = _log_poisson(fc, mu * tc) + _log_poisson(fk, mu * tk)
    p = torch.special.erfc(torch.sqrt(torch.clamp(alt - null, min=0)))
    mean_control = fc * tk / tc
    if dtype == torch.float64:
        lhs, rhs = s_c * int(t_k), s_k * int(t_c)
    else:
        lhs, rhs = mean_control, fk
    sign = torch.where(lhs > rhs, 0, torch.where(lhs < rhs, 1, 2))
    return p, sign, mean_control, fk


def significant(p: torch.Tensor, alpha: float, cutoff: float, n_tested: int):
    """The Bonferroni-significant rows, in p's own precision."""
    cut = torch.tensor(alpha / n_tested, dtype=p.dtype, device=p.device)
    pre = torch.tensor(alpha / cutoff, dtype=p.dtype, device=p.device)
    return torch.nonzero((p < cut) & (p <= pre)).squeeze(1)
