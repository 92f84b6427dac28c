"""The CPU-checkable part of kmdiff_tpu_torch/tools: the judge that
chip_smoke.py phase 2 and tools/irls_seeds.py hold K-IRLS to, on a small
block of popstrat alt fits fitted by the plain twin."""

import numpy as np
import pytest
import torch

from kmdiff_tpu_torch.ops import glm
from kmdiff_tpu_torch.tools.irls_seeds import irls_inputs, judge, well_posed, witness


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
