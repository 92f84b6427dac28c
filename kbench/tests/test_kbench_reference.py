"""The plain reference agrees with a brute-force count and with the
model's formula, and on a tiny cohort with the port's CPU `run`."""

import collections
import math

import numpy as np
import pytest
import torch
from scipy.stats import chi2

from kbench.reference import count, score
from kbench.tests.helpers import tiny_run

_COMP = str.maketrans("ACGT", "TGCA")
_ORDER = str.maketrans("ACTG", "0123")  # kmtricks: A < C < T < G


def _brute(reads: list[str], k: int) -> dict[str, int]:
    out = collections.Counter()
    for r in reads:
        for i in range(len(r) - k + 1):
            fw = r[i:i + k]
            rc = fw.translate(_COMP)[::-1]
            out[min(fw, rc, key=lambda s: s.translate(_ORDER))] += 1
    return out


@pytest.mark.parametrize("k", [5, 31, 32, 33, 63, 64, 65])
def test_count_matches_brute_force(k):
    rng = np.random.default_rng(k)
    reads = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (40, 90))]
    reads[:20, :40] = reads[20:, 50:]  # repeats, both orientations below
    keys, counts = count.count(count.canonical_keys(reads, k, "cpu"))
    got = dict(zip(count.to_strings(keys, k), counts.tolist()))
    want = _brute([r.tobytes().decode() for r in reads], k)
    assert got == want
    hist = count.histogram(counts)
    assert hist["unique"] == len(want) and hist["total"] == 40 * (90 - k + 1)


def test_merge_sums_groups():
    a = (torch.tensor([[1, 5, 9]]), torch.tensor([2, 1, 4]))
    b = (torch.tensor([[5, 7]]), torch.tensor([3, 6]))
    c = (torch.tensor([[1, 7]]), torch.tensor([1, 1]))
    keys, s_c, s_k = count.group_sums([a, b, c], nb_controls=2)
    assert keys.tolist() == [[1, 5, 7, 9]]
    assert s_c.tolist() == [2, 4, 6, 4] and s_k.tolist() == [1, 0, 1, 0]


def test_score_matches_the_model_in_f64():
    rng = np.random.default_rng(1)
    s_c = rng.integers(0, 300, 500)
    s_k = rng.integers(0, 300, 500)
    t_c, t_k = 123_456_789, 98_765_432
    p, sign, mc, mk = score.score(torch.tensor(s_c), torch.tensor(s_k), t_c, t_k,
                                  torch.float64)
    for i in range(0, 500, 7):
        c, kk = int(s_c[i]), int(s_k[i])
        mu = (c + kk) / (t_c + t_k)

        def lp(n, lam):
            return 0.0 if lam <= 0 else -lam + n * math.log(lam) - math.lgamma(n + 1)

        lr = max(lp(c, c) + lp(kk, kk) - lp(c, mu * t_c) - lp(kk, mu * t_k), 0.0)
        assert p[i].item() == pytest.approx(chi2.sf(2 * lr, 1), rel=1e-9, abs=1e-300)
        want = 0 if c * t_k > kk * t_c else 1 if c * t_k < kk * t_c else 2
        assert sign[i].item() == want
        assert mc[i].item() == c * t_k / t_c and mk[i].item() == kk


@pytest.mark.parametrize("k", [31, 63])
def test_reference_matches_the_port_on_cpu(k):
    res = tiny_run(seed=100 + k, k=k, trace=True)
    assert res["correct"], res["checks"]
    assert {"run_count_s", "run_merge_s"} <= set(res["metrics"])
    assert res["checks"]["ref_hits"]["value"] >= 1000
