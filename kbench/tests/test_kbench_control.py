"""The control: the reference in f32, its p-values printed as kmdiff
prints them, fails the comparison; the reference against itself passes."""

import pytest
import torch

from kbench import cohort, compare, control, reference
from kbench.tests.helpers import tiny_config


@pytest.mark.parametrize("k", [31, 63])
def test_f32_control_fails_f64_passes(tmp_path, k):
    cfg = tiny_config(k)
    co = cohort.make(cfg, 40 + k, str(tmp_path))
    counts = reference.count_cohort(co, k, cfg["hard_min"], torch.device("cpu"))
    numbers = control.control_numbers(counts, cfg)
    assert numbers["pval_off"] > compare.LIMITS["pval_off"]
    want = reference.expected(counts, cfg)
    printed = reference.expected(counts, cfg, printed=True)
    same = compare.compare_records(printed.records, want.records)
    assert not compare.failures({**dict.fromkeys(compare.LIMITS, 0), **same})
    assert len(want.records) > 300


def test_same_print_takes_a_tie_either_way():
    assert compare.same_print(1.23457e-10, 1.234567e-10)
    assert not compare.same_print(1.23456e-10, 1.234567e-10)
    assert compare.same_print(1.23456e-10, 1.234565e-10 * (1 + 1e-12))
