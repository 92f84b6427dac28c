"""The CPU-checkable part of kmdiff_tpu_torch/tools: the judge that
chip_smoke.py phase 2 and tools/irls_seeds.py hold K-IRLS to, and the
bitwise comparison that irls_seeds --parent holds it to against another
version, on a small block of popstrat alt fits fitted by the plain twin."""

import numpy as np
import pytest
import torch

from kmdiff_tpu_torch.ops import glm
from kmdiff_tpu_torch.tools.irls_seeds import (bit_faults, irls_inputs, judge, well_posed,
                                               witness)


@pytest.fixture(scope="module")
def block():
    args = irls_inputs(np.random.default_rng(3), 20, 5, 256, torch.device("cpu"))
    return args, glm.irls_plain(*args), witness(args)


def _with(out, i, values):
    return tuple(values if j == i else t for j, t in enumerate(out))


def test_well_posed_leaves_out_the_singular_and_separating_items(block):
    args, want, wit = block
    well = well_posed(args[2], wit)
    assert not bool(well[0]) and not bool(well[1])
    assert int(well.sum()) > 200
    assert judge(want, want, wit, args[2]) == []


@pytest.mark.parametrize("case", ["ll", "stop", "iters", "separated"])
def test_judge(block, case):
    args, want, wit = block
    well = well_posed(args[2], wit)
    b = int(torch.nonzero(well)[0])
    it, ll, stop = want[2].clone(), want[3].clone(), want[4].clone()
    if case == "ll":        # a fit at a maximum moves
        ll[b] -= 1e-3
        got, expect = _with(want, 3, ll), ["1 well-posed fits' ll beyond rtol 1e-5 / atol 1e-4"]
    elif case == "stop":    # a fit at a maximum stops otherwise
        stop[b] = 2
        got, expect = _with(want, 4, stop), ["1 well-posed fits stop otherwise"]
    elif case == "iters":   # iteration counts apart on more than 3% of the fits
        it[:16] += 1
        got, expect = _with(want, 2, it), ["iteration counts equal on 93.7500% < 97%"]
    else:                   # the separating item has no maximum: not compared
        ll[1] -= 1.0
        stop[1] = 2
        got, expect = _with(_with(want, 3, ll), 4, stop), []
    assert judge(got, want, wit, args[2]) == expect


def _one_ulp_up(t, b):
    bits = t.clone().view(torch.int32)
    bits[b] += 1
    return bits.view(torch.float32)


@pytest.mark.parametrize("case", ["equal", "ll_ulp", "iters", "w_zero_sign", "shape"])
def test_bit_faults(block, case):
    _args, want, _wit = block
    copy = tuple(t.clone() for t in want)
    b = 7
    if case == "equal":
        got, expect = copy, []
    elif case == "ll_ulp":      # one ulp in one item's ll
        got = _with(copy, 3, _one_ulp_up(copy[3], b))
        expect = [f"ll: 1 of 256 items differ (first {b})"]
    elif case == "iters":       # an iteration count off by one
        it = copy[2].clone()
        it[b] += 1
        got, expect = _with(copy, 2, it), [f"iters: 1 of 256 items differ (first {b})"]
    elif case == "w_zero_sign":  # -0.0 equals 0.0 but not in its bits
        w0, w1 = copy[0].clone(), copy[0].clone()
        w0[b, 2], w1[b, 2] = 0.0, -0.0
        got, copy = _with(copy, 0, w1), _with(copy, 0, w0)
        expect = [f"w: 1 of 256 items differ (first {b})"]
    else:                       # an output of another shape
        got = _with(copy, 4, copy[4][:-1])
        expect = ["stop: (255,) torch.int8 against (256,) torch.int8"]
    assert bit_faults(got, copy) == expect
