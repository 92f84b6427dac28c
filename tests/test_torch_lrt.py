"""The port's LR filter (kmdiff_tpu_torch.ops.lrt / lrt_kernel) against the
JAX package's lax filter and its Pallas kernel (interpret mode on the CPU).

Tolerances: the group sums are integers and must be equal. lr is f32 from
two log implementations (XLA's and PyTorch's), and lr = fc*log(..) +
fk*log(..) multiplies a one-ulp difference of a log by the row's count, so
the bound has a count term: |lr - lr_ref| <= 1e-6*|lr_ref| + 1e-6 +
2.5e-7*tot. Each implementation stays within 1.2e-7*tot of the f64 value
on these inputs, so 2.5e-7 per count bounds their difference; it is a
sixteenth of the filter's own margin (4e-6 per count), which the port is
also held to against f64. keep must be equal except on rows whose
margin-adjusted lr lies within that bound of lr_min.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmdiff_tpu.ops.lrt import LrtParams as JaxLrtParams
from kmdiff_tpu.ops.lrt import lrt_filter_block as jax_lrt_filter_block
from kmdiff_tpu.ops.lrt_pallas import lrt_filter_block_pallas
from kmdiff_tpu_torch.ops.lrt import (
    MARGIN_ABS,
    MARGIN_PER_COUNT,
    LrtParams,
    lr_threshold_for_pvalue,
    run_filter,
)
from kmdiff_tpu_torch.ops.lrt_kernel import lrt_filter, lrt_filter_plain


def _counts(rng, B, S):
    counts = rng.integers(0, 64, size=(B, S), dtype=np.int32)
    counts[rng.random(B) < 0.1] = 0
    return counts


def assert_filter_close(ours, ref, lr_min):
    """Equal sums, lr within the module's bound, keep equal off the
    boundary."""
    keep, lr, s_c, s_k = (np.asarray(x) for x in ours)
    keep_r, lr_r, s_c_r, s_k_r = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(s_c, s_c_r)
    np.testing.assert_array_equal(s_k, s_k_r)
    tot = (s_c_r + s_k_r).astype(np.float64)
    tol = 1e-6 * np.abs(lr_r) + 1e-6 + 2.5e-7 * tot
    bad = np.abs(lr.astype(np.float64) - lr_r) > tol
    assert not bad.any(), (lr[bad], lr_r[bad], tot[bad])
    adj = lr_r + MARGIN_PER_COUNT * tot + MARGIN_ABS
    boundary = np.abs(adj - lr_min) <= tol
    np.testing.assert_array_equal(keep[~boundary], keep_r[~boundary])


def assert_within_margin_of_f64(ours, params):
    """The f32 lr stays inside the filter's margin of the exact f64 LR —
    the property that keeps every f64 hit in the survivor set."""
    _keep, lr, s_c, s_k = (np.asarray(x) for x in ours)
    fc, fk = s_c.astype(np.float64), s_k.astype(np.float64)
    tot = fc + fk
    with np.errstate(divide="ignore", invalid="ignore"):
        exact = (np.where(fc > 0, fc * np.log(fc / (tot * float(params.ratio_c))), 0)
                 + np.where(fk > 0, fk * np.log(fk / (tot * float(params.ratio_k))), 0))
    exact = np.maximum(exact, 0.0)
    assert (np.abs(lr - exact) <= MARGIN_PER_COUNT * tot + MARGIN_ABS).all()


@pytest.mark.parametrize("nb_controls,S", [(10, 20), (3, 8), (1, 2)])
def test_plain_filter_matches_jax_and_pallas(nb_controls, S):
    rng = np.random.default_rng(0)
    counts = _counts(rng, 2048, S)
    # a p threshold that puts real rows on both sides of the cut
    params = JaxLrtParams(nb_controls, S - nb_controls, 500_000, 600_000, 0.05)
    jargs = (jnp.asarray(counts), nb_controls, jnp.float32(params.ratio_c),
             jnp.float32(params.ratio_k), jnp.float32(params.lr_min))
    ref = jax_lrt_filter_block(*jargs)
    pallas = lrt_filter_block_pallas(*jargs, interpret=True)

    ours = lrt_filter(torch.from_numpy(counts), nb_controls, params.ratio_c,
                      params.ratio_k, params.lr_min)
    assert ours[0].dtype == torch.bool and ours[1].dtype == torch.float32
    assert ours[2].dtype == torch.int32 and ours[3].dtype == torch.int32
    assert_filter_close(ours, ref, params.lr_min)
    assert_filter_close(ours, pallas, params.lr_min)
    assert_within_margin_of_f64(ours, params)
    assert 0 < int(ours[0].sum()) < len(counts)


def test_lrt_params_bit_equal():
    for args in [(10, 10, 123_456_789, 987_654_321, 0.05 / 1e5),
                 (1, 1, 160, 160, 0.05), (3, 5, 7, 11, 1.0),
                 (2, 2, 10, 20, 0.0)]:
        ours, ref = LrtParams(*args), JaxLrtParams(*args)
        assert ours.ratio_c.tobytes() == ref.ratio_c.tobytes()
        assert ours.ratio_k.tobytes() == ref.ratio_k.tobytes()
        assert ours.lr_min == ref.lr_min
        assert ours.wide_sums == ref.wide_sums
    assert lr_threshold_for_pvalue(1.0) == 0.0
    assert lr_threshold_for_pvalue(0.0) == float("inf")


def test_run_filter_any_rows_and_uint32():
    """run_filter takes any B (no tile padding) and uint32 count views, and
    returns keep and the sums (no lr, which its caller does not read)."""
    rng = np.random.default_rng(1)
    counts = _counts(rng, 1000, 6).astype(np.uint32)
    params = LrtParams(2, 4, 1000, 3000, 0.01)
    keep, s_c, s_k = run_filter(params, counts, torch.device("cpu"))
    assert keep.shape == s_c.shape == s_k.shape == (1000,)
    np.testing.assert_array_equal(s_c, counts[:, :2].sum(1))
    ref = jax_lrt_filter_block(
        jnp.asarray(counts.view(np.int32)), 2, jnp.float32(params.ratio_c),
        jnp.float32(params.ratio_k), jnp.float32(params.lr_min))
    lr = lrt_filter(torch.from_numpy(counts.view(np.int32)), 2, params.ratio_c,
                    params.ratio_k, params.lr_min)[1]
    assert_filter_close((keep, lr, s_c, s_k), ref, params.lr_min)


def test_plain_twin_is_the_cpu_path():
    counts = torch.from_numpy(_counts(np.random.default_rng(2), 64, 4))
    a = lrt_filter(counts, 2, 0.5, 0.5, 3.0)
    b = lrt_filter_plain(counts, 2, 0.5, 0.5, 3.0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
