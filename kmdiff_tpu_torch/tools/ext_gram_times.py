"""K-EXT's multi-word form's and K-GRAM's device times of one or two
checkouts of kmdiff_tpu_torch, at chip_smoke.py phase 2's shapes.

Run on a CUDA card from the root of a checkout:

    python3 kmdiff_tpu_torch/tools/ext_gram_times.py --root DIR
    python3 kmdiff_tpu_torch/tools/ext_gram_times.py --paired OTHER_DIR

The two forms are tools/paired_runs.py's: one checkout's JSON line, or
four in turns with another checkout's and a table.

Inputs and timers are this checkout's (chip_smoke.py's median_ms,
events_ms and device_work), drawn from seeded streams as phase 2 draws
them. Calls:
- ext_k63, ext_k128: codec.canonical_kmers on 2^24 codes (INVALID every
  151 bytes) at k = 63 and 128, the multi-word form.
- gram_b20_s20, gram_b18_s200: pca.int_gram on [2^20, 20] and [2^18, 200]
  0/1 blocks (density 0.4); gram_b18_s256 and gram_b18_s257 on either
  side of K-GRAM's two forms; gram_b16_s1000 and gram_b14_s5000 in its
  tiled form.
- gram_groups: pca.int_gram once on each of GROUP_ROWS' blocks of 20
  samples (density 0.4), the row-sum groups of the geno matrix that
  chip_smoke.py phase 5 logs, in its order; the times are the whole
  sequence's (device_ms over 2 queued sequences) and device_ops is a
  call's.
Each is checked against its plain twin and reported as the median whole
call (CUDA events around one call), its device time (CUDA events around 20
calls queued back to back behind a sleep kernel, over 20: device_ms) and
torch.profiler's device time and device operations a call (profiler_ms,
device_ops).
"""

from __future__ import annotations

import os
import sys

import paired_runs

#: rows of the 18 row-sum groups of phase 5's geno matrix (S = 20)
GROUP_ROWS = (3088, 10, 1, 18, 47, 161, 377, 684, 1031, 1398, 1494, 1345, 1002, 568,
              295, 98, 28, 5)
#: K-GRAM's [log2 B, S] blocks past the first two
GRAM_MORE = ((18, 256), (18, 257), (16, 1000), (14, 5000))


def measure(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import kmdiff_tpu_torch
    from kmdiff_tpu_torch import kernels
    from kmdiff_tpu_torch.ops import codec, pca

    if not kmdiff_tpu_torch.__file__.startswith(os.path.abspath(root)):
        raise AssertionError(f"kmdiff_tpu_torch came from {kmdiff_tpu_torch.__file__}")
    smoke = paired_runs.smoke()
    kernels.lib()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(7)
    calls = {}
    for k in (63, 128):
        codes_np = rng.integers(0, 4, 1 << 24).astype(np.uint8)
        codes_np[150::151] = codec.INVALID
        codes = torch.from_numpy(codes_np).to(dev)
        calls[f"ext_k{k}"] = ((lambda c=codes, k=k: codec.canonical_kmers(c, k)),
                              (lambda c=codes, k=k: codec.canonical_kmers_mw_plain(c, k)))
    for lg, S in ((20, 20), (18, 200)) + GRAM_MORE:
        X = torch.from_numpy((rng.random((1 << lg, S)) < 0.4).astype(np.uint8)).to(dev)
        calls[f"gram_b{lg}_s{S}"] = ((lambda X=X: pca.int_gram(X)),
                                     (lambda X=X: pca.int_gram_plain(X)))
    groups = [torch.from_numpy((rng.random((B, 20)) < 0.4).astype(np.uint8)).to(dev)
              for B in GROUP_ROWS]

    calls["gram_groups"] = ((lambda: [pca.int_gram(X) for X in groups]),
                            (lambda: [pca.int_gram_plain(X) for X in groups]))
    out = {"root": root}
    for label, (call, plain) in calls.items():
        got, want = call(), plain()
        if isinstance(got, torch.Tensor):
            got, want = [got], [want]
        if not all(map(torch.equal, got, want)):
            raise AssertionError(f"{label} differs from the plain twin")
        prof_ms, n_ops = smoke.device_work(call)
        # 20 queued sequences of 18 three-launch calls would outlast the
        # launch queue behind the sleep kernel: 2 sequences of groups
        n = 20 if len(got) == 1 else 2
        out[label] = {"ms": smoke.median_ms(call), "device_ms": smoke.events_ms(call, n=n),
                      "profiler_ms": prof_ms, "device_ops": n_ops / len(got)}
    return out


if __name__ == "__main__":
    paired_runs.main(__doc__, measure, __file__)
