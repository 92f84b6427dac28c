"""Host logistic-regression solvers (reference-parity scalar path).

Reference: src/linear_model.cpp:68-410 — hand-rolled dense algebra with two
fitters: Newton-Raphson with learning rate and IRLS (the shipped default:
KMD_USE_IRLS is defined unconditionally, src/CMakeLists.txt:28). This module
reproduces the reference's *algorithms* (same initialization, same working
response z = eta + (y-mu)/g, same mean-squared-error convergence test with
eps=1e-6, same singular-Hessian bailout) on numpy.

The batched device version used for the per-k-mer alt fits lives in
ops.glm (K-IRLS); this host version fits the null model with --irls off
and runs the --compat-popstrat fits.
"""

from __future__ import annotations

import numpy as np

_EPS_CONV = 1e-6
_G_FLOOR = 1e-305


def sigmoid(x):
    # large |x| overflows exp to inf exactly like the reference's C++
    # (linear_model.cpp:191-203, 1/(1+exp(-x)) in double); the result is a
    # correct 0.0, so the warning is scoped out rather than "fixed"
    with np.errstate(over="ignore"):
        return 1.0 / (1.0 + np.exp(-x))


def predict(model: np.ndarray, data: np.ndarray) -> float:
    """p = sigmoid(<model, data>) (reference: linear_model.cpp:205-211)."""
    return float(sigmoid(np.dot(model, data)))


def lu_decomposition(m: np.ndarray):
    """Doolittle LU (no pivoting — matches reference numerics,
    linear_model.cpp:95-132)."""
    n = m.shape[0]
    lower = np.zeros((n, n))
    upper = np.zeros((n, n))
    for i in range(n):
        for k in range(i, n):
            upper[i, k] = m[i, k] - lower[i, :i] @ upper[:i, k]
        lower[i, i] = 1.0
        for k in range(i + 1, n):
            lower[k, i] = (m[k, i] - lower[k, :i] @ upper[:i, i]) / upper[i, i]
    return lower, upper


def inverse(m: np.ndarray):
    """LU-based inverse; returns (inv, singular, nan)
    (reference: linear_model.cpp:134-189)."""
    n = m.shape[0]
    with np.errstate(divide="ignore", invalid="ignore"):
        lower, upper = lu_decomposition(m)
        det = float(np.prod(np.diag(upper)))
        if det == 0.0:
            return np.zeros((n, n)), True, False
        if np.isnan(det):
            return np.zeros((n, n)), False, True
        inv = np.zeros((n, n))
        eye = np.eye(n)
        for c in range(n):
            # forward substitution (lower is unit triangular)
            y = np.zeros(n)
            for r in range(n):
                y[r] = eye[r, c] - lower[r, :r] @ y[:r]
            # back substitution
            x = np.zeros(n)
            for r in range(n - 1, -1, -1):
                x[r] = (y[r] - upper[r, r + 1 :] @ x[r + 1 :]) / upper[r, r]
            inv[:, c] = x
    if np.isnan(inv).any():
        return inv, False, True
    return inv, False, False


def glm_irls(x: np.ndarray, y: np.ndarray, max_iters: int = 500):
    """Iteratively reweighted least squares for logistic regression
    (reference: linear_model.cpp:297-410).

    Returns (weights [F], singular, nan, error, iterations).
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n, F = x.shape
    weight = np.ones(F)
    mu = (y + 0.5) / 2.0
    with np.errstate(divide="ignore"):
        eta = np.log(mu / (1.0 - mu))
    prev_error = 1e18
    singular = nan = False
    iters = 0
    error = prev_error

    while True:
        g = mu * (1.0 - mu)
        good = g > _G_FLOOR
        if not good.any():
            break
        error = float(np.mean((y - mu) ** 2))
        if abs(error - prev_error) < _EPS_CONV:
            break
        prev_error = error

        Xg = x[good]
        gg = g[good]
        z = eta[good] + (y[good] - mu[good]) / (gg + _G_FLOOR)
        hessian = Xg.T @ (gg[:, None] * Xg)
        hinv, singular, nan = inverse(hessian)
        if singular or nan:
            break
        w = hinv @ (Xg.T @ (gg * z))
        iters += 1
        if iters >= max_iters:
            break
        weight = w
        eta = x @ w
        mu = sigmoid(eta)

    return weight, singular, nan, error, iters


def glm_newton_raphson(x: np.ndarray, y: np.ndarray, gamma: float = 0.1,
                       max_iters: int = 500):
    """Gradient/Hessian Newton steps with learning rate
    (reference: linear_model.cpp:213-295). Kept for the --irls=false dev
    path and plugin parity."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n, F = x.shape
    weight = 1.0 / np.max(x, axis=0)
    prev_error = 1e18
    singular = nan = False
    iters = 0
    error = prev_error

    while True:
        z = x @ weight
        alpha = sigmoid(z)
        error = float(np.mean((y - alpha) ** 2))
        if abs(error - prev_error) < _EPS_CONV:
            break
        prev_error = error
        b = alpha * (1.0 - alpha)
        hessian = x.T @ (b[:, None] * x)
        hinv, singular, nan = inverse(hessian)
        if singular or nan:
            return weight, singular, nan, error, iters
        gradient = x.T @ (alpha - y)
        weight = weight - gamma * (hinv @ gradient)
        iters += 1
        if iters >= max_iters:
            break

    return weight, singular, nan, error, iters
