"""Batched logistic regression by IRLS (port of kmdiff_tpu/ops/glm.py).

Popstrat fits one null model and one alt model per significant k-mer; the
alt designs share every column but the last. K-IRLS fits one item a
warp, several a block (irls_layout), and returns each fit's Bernoulli
log-likelihood from the same launch:

  K-IRLS irls   X [Bx, n, F] f32 (Bx = 1 shared, or B), last [B, n] or
                None, y [n] -> w [B, F], err [B], iters [B] int32, ll [B],
                stop [B] int8 (0 converged, 1 frozen by a singular or
                non-finite solve, 2 max_iters)

The semantics are kmdiff_tpu/ops/glm.py::_irls_single's, quirks included
(irls.cu lists them). Everything is f32, as the JAX package runs on the CPU
(64-bit mode off) and on the TPU, and the plain twin's products are full
f32, never TF32: reduced-precision passes moved popstrat's survivor counts
100x in the JAX package (kmdiff_tpu/ops/glm.py:26-30).
"""

from __future__ import annotations

import ctypes

import torch

from kmdiff_tpu_torch import kernels

_EPS_CONV = 1e-6
#: kmdiff_tpu/ops/glm.py's g floors for f32 and f64 designs
_G_FLOOR = 1e-30
_G_FLOOR_F64 = 1e-305


def default_dtype() -> torch.dtype:
    """The fits' dtype: f32 on every device."""
    return torch.float32


def _design(X: torch.Tensor, last: torch.Tensor | None) -> torch.Tensor:
    """[B, n, F] designs: X's items (or its one shared item) with the last
    column replaced by last[b]."""
    B = X.shape[0] if last is None else last.shape[0]
    Xi = X.expand(B, *X.shape[1:]).clone()
    if last is not None:
        Xi[:, :, -1] = last
    return Xi


def _softplus(z: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(z, torch.zeros_like(z))


def _ll_from_logits(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return -(y * _softplus(-z) + (1.0 - y) * _softplus(z)).sum(1)


def irls_plain(X, last, y, max_iters: int = 500, eps_conv: float = _EPS_CONV):
    """irls's plain twin; it also fits f64 designs, with the JAX package's
    f64 g floor."""
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("irls_plain needs full f32 products: "
                           "torch.get_float32_matmul_precision() must be "
                           "'highest', not TF32 or bf16 passes")
    Xi = _design(X, last)
    B, n, F = Xi.shape
    dev = Xi.device
    g_floor = _G_FLOOR if Xi.dtype == torch.float32 else _G_FLOOR_F64
    mu = ((y + 0.5) / 2.0).expand(B, n).clone()
    eta = torch.log(mu / (1.0 - mu))
    w = torch.ones((B, F), dtype=Xi.dtype, device=dev)
    prev = torch.full((B,), 1e18, dtype=Xi.dtype, device=dev)
    err = prev.clone()
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    stop = torch.zeros(B, dtype=torch.int8, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    Xt = Xi.transpose(1, 2)
    while not bool(done.all()):
        act = ~done
        g = mu * (1.0 - mu)
        good = g > g_floor
        error = ((y - mu) ** 2).mean(1)
        conv = ((error - prev).abs() < eps_conv) | ~good.any(1)
        gz = torch.where(good, g * eta + (y - mu), 0.0)
        gw = torch.where(good, g, 0.0)
        H = (Xi * gw[:, :, None]).transpose(1, 2) @ Xi
        rhs = (Xt @ gz[:, :, None])[:, :, 0]
        new_w, info = torch.linalg.solve_ex(H, rhs)
        bad = (info != 0) | ~torch.isfinite(new_w).all(1)
        hit = iters + 1 >= max_iters
        adv = act & ~conv & ~bad & ~hit
        w = torch.where(adv[:, None], new_w, w)
        eta = torch.where(adv[:, None], (Xi @ new_w[:, :, None])[:, :, 0], eta)
        mu = torch.where(adv[:, None], torch.sigmoid(eta), mu)
        err = torch.where(act, error, err)
        prev = torch.where(act & ~conv, error, prev)
        iters = torch.where(act & ~conv, iters + 1, iters)
        stop = torch.where(act & ~conv & bad, 1,
                           torch.where(act & ~conv & ~bad & hit, 2, stop)
                           ).to(torch.int8)
        done = done | conv | bad | hit
    if last is None:
        ll = log_likelihood(Xi, w, y)
    else:
        ll = log_likelihood_lastcol(X[0], last, w, y)
    return w, err, iters, ll, stop


def irls_layout(n: int, F: int, shared_design: bool, has_last: bool,
                smem_limit: int) -> tuple[int, bool, int]:
    """K-IRLS's launch layout for n samples and F features within
    smem_limit bytes of shared memory a block: (fits a block, whether the
    designs are staged in shared memory, the block's shared bytes); fits is
    0 where not even one fit a block fits. shared_design: one design X[0]
    for every item."""
    fits, staged = ctypes.c_int(), ctypes.c_int()
    nbytes = kernels.lib().kmd_irls_layout(n, F, int(shared_design), int(has_last),
                                           smem_limit, ctypes.byref(fits),
                                           ctypes.byref(staged))
    return fits.value, bool(staged.value), nbytes


def irls(X: torch.Tensor, last: torch.Tensor | None, y: torch.Tensor,
         max_iters: int = 500, eps_conv: float = _EPS_CONV):
    """K-IRLS: logistic IRLS of B items, item b's design X[b] (or X[0]
    when X holds one item) with its last column replaced by last[b] when
    last is given; shared labels y. Returns (w [B, F], err [B], iters [B]
    int32, ll [B], stop [B] int8), all f32 but iters and stop."""
    if X.device.type == "cpu":
        return irls_plain(X, last, y, max_iters, eps_conv)
    kernels.require_cuda_tensor("irls X", X, torch.float32)
    kernels.require_cuda_tensor("irls y", y, torch.float32)
    if X.dim() != 3:
        raise ValueError(f"irls: X must be [B, n, F], got {tuple(X.shape)}")
    Bx, n, F = X.shape
    if last is not None:
        kernels.require_cuda_tensor("irls last", last, torch.float32)
        if last.dim() != 2 or last.shape[1] != n:
            raise ValueError(f"irls: last must be [B, {n}], got {tuple(last.shape)}")
        B = last.shape[0]
    else:
        B = Bx
    if Bx not in (1, B) or y.shape != (n,):
        raise ValueError(f"irls: X {tuple(X.shape)}, y {tuple(y.shape)} and "
                         f"{B} items do not agree")
    max_f = kernels.lib().kmd_irls_max_features()
    if F > max_f:
        raise ValueError(f"irls: {F} features, at most {max_f}")
    limit = torch.cuda.get_device_properties(X.device).shared_memory_per_block_optin
    if irls_layout(n, F, Bx == 1, last is not None, limit)[0] == 0:
        raise ValueError(f"irls: {n} samples x {F} features exceed the "
                         "block's shared memory")
    dev = X.device
    w = torch.empty((B, F), dtype=torch.float32, device=dev)
    err = torch.empty(B, dtype=torch.float32, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    ll = torch.empty(B, dtype=torch.float32, device=dev)
    stop = torch.empty(B, dtype=torch.int8, device=dev)
    if B:
        with torch.cuda.device(dev):
            kernels.launch("irls", "kmd_irls", X.data_ptr(),
                           0 if Bx == 1 else n * F, kernels.ptr(last),
                           y.data_ptr(), B, n, F, max_iters, _G_FLOOR,
                           eps_conv, limit, w.data_ptr(), err.data_ptr(),
                           iters.data_ptr(), ll.data_ptr(), stop.data_ptr())
    return w, err, iters, ll, stop


def batched_irls(X: torch.Tensor, y: torch.Tensor, max_iters: int = 500,
                 eps_conv: float = _EPS_CONV):
    """IRLS over [B, n, F] designs -> (weights [B, F], error [B], iters [B])."""
    return irls(X, None, y, max_iters, eps_conv)[:3]


def batched_irls_lastcol(X_base: torch.Tensor, last: torch.Tensor,
                         y: torch.Tensor, max_iters: int = 500):
    """IRLS of the shared [n, F] design with a per-item last column [B, n]
    (popstrat's alt fits) -> (weights [B, F], error [B], iters [B])."""
    return irls(X_base[None], last, y, max_iters)[:3]


def log_likelihood(X: torch.Tensor, w: torch.Tensor, y: torch.Tensor):
    """Per-item Bernoulli log-likelihood of p = sigmoid(X w): X [B, n, F],
    w [B, F], y [n] -> [B]."""
    return _ll_from_logits((X @ w[:, :, None])[:, :, 0], y)


def log_likelihood_lastcol(X_base: torch.Tensor, last: torch.Tensor,
                           w: torch.Tensor, y: torch.Tensor):
    """log_likelihood of the shared design with per-item last columns:
    z = X_base[:, :-1] w[:, :-1] + last w[:, -1]."""
    zb = (X_base[:, :-1] @ w[:, :-1].T).T
    return _ll_from_logits(zb + last * w[:, -1:], y)
