"""K-IRLS against its plain twin over many input draws.

Run on a CUDA card from the root of a checkout:

    python3 -m kmdiff_tpu_torch.tools.irls_seeds [--seeds 64] [--tf32] [--parent REV]

Each draw is chip_smoke.py phase 2's block of popstrat alt fits
(irls_inputs), 2^14 items at n = 20, F = 5 and at n = 200, F = 12, from
numpy's default_rng(seed), fitted by the kernel, by its plain twin and, as a
witness, by the twin in f64. Each draw is judged as phase 2 judges it
(judge) and gets a line. Then, for each shape over all draws, the fits the
witness finds at a maximum (well_posed) are binned by the witness's largest
weight, each bin with its fits, those whose iteration counts or stop codes
differ from the twin's and those whose ll lies beyond rtol 1e-5 / atol 1e-4
at equal counts; then the same counts for the fits the witness finds
separated or diverged. The last line is a JSON summary.

--tf32 runs the same draws a second time through a planted variant of
K-IRLS whose products round their operands to TF32 (what the JAX package
measured to move popstrat's results, kmdiff_tpu/ops/glm.py:26-30), built in
a copy of the package under build/tools/: the check must fail it. --device
cpu runs the plain twin on both sides, a check of the script alone.

--parent REV holds this K-IRLS bit for bit against another version's: REV
is a git revision of this repository (its kmdiff_tpu_torch taken with git
archive) or a directory holding another checkout (for a machine without
the repository's history, e.g. a git archive unpacked under a directory
that .gitignore lists). That package is copied under
build/tools/irls_parent/, where its kernels build, and run by this script
in a subprocess over the same draws (its inputs' hashes must match);
every item's w, err, iters, ll and stop must be equal in every bit
(bit_faults). The exit code is 1 if any bit differs.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import tarfile
import tempfile

import numpy as np
import torch

#: a fit that separates its labels has no maximum: its ll creeps to 0
#: until the stop rule fires; the witness's ll above this marks one
SEP_LL = -0.05
SHAPES = ((20, 5), (200, 12))
ITEMS = 1 << 14


def irls_inputs(rng, n: int, F: int, B: int, dev):
    """A popstrat alt-fit block: the conditioned shared design [1 | PCs |
    totals] and each item's centered, max-abs-scaled count-ratio column;
    item 0 constant (singular), item 1 separating the labels. Returns the
    arguments of glm.irls but max_iters."""
    from kmdiff_tpu_torch.pipeline.popstrat import _condition_design

    y = np.concatenate([np.ones(n // 2), np.zeros(n - n // 2)])
    X = np.column_stack([np.ones(n), rng.normal(0, 0.2, (n, F - 3)),
                         rng.uniform(5.9e6, 6.1e6, n)])
    Xc, _c, _s = _condition_design(X)
    Xb = np.column_stack([Xc, np.zeros(n)])
    r = rng.poisson(20.0 + 3.0 * y * (rng.random((B, 1)) < 0.3), (B, n))
    r = r / rng.uniform(5.9e6, 6.1e6, n)
    r[0] = 1.0
    r[1] = np.where(y == 1, 2.0, 1.0)
    r = r - r.mean(1, keepdims=True)
    r = r / np.maximum(np.abs(r).max(1, keepdims=True), 1e-300)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    return t(Xb)[None].contiguous(), t(r), t(y)


#: bins of the witness's largest weight
W_BINS = (2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 256.0, float("inf"))
#: the least share of fits whose iteration counts agree with the twin's:
#: the kernel's lowest over 64 draws a shape was 98.87%, the TF32 variant's
#: highest 94.63% (NVIDIA H100 80GB HBM3, 700 W)
ITERS_EQUAL_MIN = 0.97


def witness(args):
    """The block refitted in f64 by the plain twin: (w, iters, ll, stop)."""
    from kmdiff_tpu_torch.ops import glm

    X, last, y = args
    w, _e, it, ll, stop = glm.irls_plain(X.double(), last.double(), y.double(), 500)
    return w, it, ll, stop


def well_posed(y, wit):
    """[B] bool: the fits the f64 witness finds at a maximum: converged,
    not separating the labels (ll < SEP_LL) and no worse than the
    intercept-only model (a diverged Newton step lands below it)."""
    _w, _it, ll64, stop64 = wit
    p = float(y.double().mean())
    ll_null = y.numel() * (p * math.log(p) + (1 - p) * math.log(1 - p))
    return (stop64 == 0) & (ll64 < SEP_LL) & (ll64 >= ll_null - 1e-6)


def judge(got, want, wit, y) -> list[str]:
    """What fails K-IRLS's check against its twin, empty when it passes:
    iteration counts equal on at least ITERS_EQUAL_MIN of the fits; on the
    fits the f64 witness finds well posed, stop codes equal and, where the
    iteration counts agree, ll within rtol 1e-5 / atol 1e-4. A separated or
    diverged fit has no maximum and lands wherever its roundings take it,
    in f64 as well: it is counted, not compared."""
    _w, _e, it, ll, stop = got
    _w, _e, it_p, ll_p, stop_p = want
    well = well_posed(y, wit)
    same_it = it == it_p
    close = torch.isclose(ll, ll_p, rtol=1e-5, atol=1e-4)
    faults = []
    share = float(same_it.float().mean())
    if share < ITERS_EQUAL_MIN:
        faults.append(f"iteration counts equal on {share:.4%} < {ITERS_EQUAL_MIN:.0%}")
    bad_stop = int((well & (stop != stop_p)).sum())
    if bad_stop:
        faults.append(f"{bad_stop} well-posed fits stop otherwise")
    bad_ll = int((well & same_it & ~close).sum())
    if bad_ll:
        faults.append(f"{bad_ll} well-posed fits' ll beyond rtol 1e-5 / atol 1e-4")
    return faults


def sweep(seeds: int, dev, label: str) -> dict:
    from kmdiff_tpu_torch.ops import glm

    summary = {}
    for n, F in SHAPES:
        nb = len(W_BINS)
        # per bin of the witness's max |w| among the well-posed fits: fits,
        # iteration counts apart, stops apart, ll beyond tolerance with
        # equal iteration counts, the largest gap at equal counts
        acc = [[0, 0, 0, 0, 0.0] for _ in range(nb)]
        other = [0, 0, 0]  # separated or diverged in f64: fits, stops apart, ll apart
        failing, shares = [], []
        for seed in range(seeds):
            args = irls_inputs(np.random.default_rng(seed), n, F, ITEMS, dev)
            got = glm.irls(*args, 500)
            want = glm.irls_plain(*args, 500)
            wit = witness(args)
            faults = judge(got, want, wit, args[2])
            if faults:
                failing.append(seed)
            it, ll, stop = got[2], got[3], got[4]
            it_p, ll_p, stop_p = want[2], want[3], want[4]
            shares.append(float((it == it_p).float().mean()))
            wmax = wit[0].abs().amax(1).float()
            base = well_posed(args[2], wit)
            close = torch.isclose(ll, ll_p, rtol=1e-5, atol=1e-4)
            gap = (ll - ll_p).abs()
            lo = -1.0
            for i, hi in enumerate(W_BINS):
                m = base & (wmax > lo) & (wmax <= hi)
                lo = hi
                same = m & (it == it_p)
                acc[i][0] += int(m.sum())
                acc[i][1] += int((m & (it != it_p)).sum())
                acc[i][2] += int((m & (stop != stop_p)).sum())
                acc[i][3] += int((same & ~close).sum())
                if bool(same.any()):
                    acc[i][4] = max(acc[i][4], float(gap[same].max()))
            other[0] += int((~base).sum())
            other[1] += int((~base & (stop != stop_p)).sum())
            other[2] += int((~base & ~close).sum())
            print(f"[{label}] seed {seed} n={n} F={F}: {int(base.sum())} fits at a "
                  f"maximum in f64, iters equal on {shares[-1]:.4%}; "
                  f"{'; '.join(faults) or 'passes'}", flush=True)
        for i, hi in enumerate(W_BINS):
            c = acc[i]
            print(f"[{label}] n={n} F={F} f64 max|w| <= {hi:g}: {c[0]} fits, "
                  f"{c[1]} iteration counts apart, {c[2]} stops apart, {c[3]} ll "
                  f"beyond tolerance at equal counts (largest gap {c[4]:.3g})")
        print(f"[{label}] n={n} F={F} separated or diverged in f64: {other[0]} "
              f"fits, {other[1]} stops apart, {other[2]} ll beyond tolerance")
        summary[f"n={n},F={F}"] = {
            "draws": seeds, "failing_draws": failing,
            "iters_equal_min": min(shares), "iters_equal_max": max(shares),
            "bins": {f"{hi:g}": c for hi, c in zip(W_BINS, acc)},
            "separated_or_diverged": other}
    return summary


OUTPUTS = ("w", "err", "iters", "ll", "stop")


def bit_faults(got, want) -> list[str]:
    """What differs between two K-IRLS results (w, err, iters, ll, stop),
    empty when every item's five outputs are equal in every bit: per
    output, the items that differ (f32 compared as their bits, so a NaN
    payload or the sign of a zero counts)."""
    faults = []
    for name, g, w in zip(OUTPUTS, got, want):
        g, w = g.detach().cpu(), w.detach().cpu()
        if g.shape != w.shape or g.dtype != w.dtype:
            faults.append(f"{name}: {tuple(g.shape)} {g.dtype} against "
                          f"{tuple(w.shape)} {w.dtype}")
            continue
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        apart = (g != w).reshape(g.shape[0], -1).any(1)
        if bool(apart.any()):
            faults.append(f"{name}: {int(apart.sum())} of {g.shape[0]} items differ "
                          f"(first {int(torch.nonzero(apart)[0])})")
    return faults


def _input_hash(args) -> str:
    h = hashlib.sha1()
    for t in args:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _draws(seeds: int, dev):
    """((n, F), seed, glm.irls arguments) for every draw of the sweep."""
    for n, F in SHAPES:
        for seed in range(seeds):
            yield (n, F), seed, irls_inputs(np.random.default_rng(seed), n, F, ITEMS, dev)


def dump(path: str, seeds: int, dev) -> None:
    """K-IRLS's outputs and the inputs' hashes of every draw, saved to path,
    from the kmdiff_tpu_torch this process imports."""
    import kmdiff_tpu_torch
    from kmdiff_tpu_torch.ops import glm

    out = {"package": kmdiff_tpu_torch.__file__}
    for shape, seed, args in _draws(seeds, dev):
        out[shape, seed] = (_input_hash(args),
                            tuple(t.cpu() for t in glm.irls(*args, 500)))
    torch.save(out, path)


def _parent_copy(rev: str) -> str:
    """kmdiff_tpu_torch of rev (a git revision of this repository, or a
    directory holding a checkout) copied under build/tools/irls_parent."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    root = os.path.join(repo, "build", "tools", "irls_parent")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    if os.path.isdir(rev):
        shutil.copytree(os.path.join(rev, "kmdiff_tpu_torch"),
                        os.path.join(root, "kmdiff_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__", "build"))
        return root
    with tempfile.TemporaryFile() as tar:
        subprocess.run(["git", "archive", rev, "kmdiff_tpu_torch"], cwd=repo,
                       stdout=tar, check=True)
        tar.seek(0)
        with tarfile.open(fileobj=tar) as t:
            t.extractall(root, filter="data")
    return root


def parent_check(rev: str, seeds: int, dev) -> dict:
    """Every draw's K-IRLS outputs against rev's, bit for bit."""
    from kmdiff_tpu_torch.ops import glm

    root = _parent_copy(rev)
    path = os.path.join(root, "outputs.pt")
    env = dict(os.environ, PYTHONPATH=root)
    subprocess.run([sys.executable, os.path.abspath(__file__), "--dump", path,
                    "--seeds", str(seeds), "--device", str(dev)],
                   cwd=root, env=env, check=True)
    theirs = torch.load(path)
    if not theirs.pop("package").startswith(root):
        raise AssertionError("the parent run did not import its own package")
    summary = {}
    for (n, F), seed, args in _draws(seeds, dev):
        digest, want = theirs[(n, F), seed]
        if digest != _input_hash(args):
            raise AssertionError(f"seed {seed} n={n} F={F}: the parent's inputs differ")
        faults = bit_faults(glm.irls(*args, 500), want)
        print(f"[parent {rev}] seed {seed} n={n} F={F}: "
              f"{'; '.join(faults) or f'all {ITEMS} items bit-identical'}", flush=True)
        s = summary.setdefault(f"n={n},F={F}", {"draws": 0, "items": 0, "faults": []})
        s["draws"] += 1
        s["items"] += ITEMS
        s["faults"] += [f"seed {seed}: {f}" for f in faults]
    return summary


def _planted_copy() -> str:
    """A copy of the package whose K-IRLS rounds its products' operands to
    TF32 (cvt.rna, as the tensor cores take f32 inputs): the Hessian's and
    the right-hand side's products and the linear predictor's."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = os.path.join(os.path.dirname(pkg), "build", "tools", "irls_tf32")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(pkg, os.path.join(root, "kmdiff_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = os.path.join(root, "kmdiff_tpu_torch", "csrc", "irls.cu")
    with open(src) as f:
        text = f.read()
    edits = [
        ("namespace {\n", "namespace {\n\n__device__ __forceinline__ float tf32(float v) {\n"
         "  unsigned r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(r) : \"f\"(v));\n"
         "  return __uint_as_float(r);\n}\n"),
        ("h = (xj * g) * xk;", "h = tf32(xj * g) * tf32(xk);"),
        ("r = xj * z;", "r = tf32(xj) * tf32(z);"),
        ("e += d(i, j) * w[j];", "e += tf32(d(i, j)) * tf32(w[j]);"),
    ]
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"irls.cu no longer holds {old!r} once")
        text = text.replace(old, new)
    with open(src, "w") as f:
        f.write(text)
    return root


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=64)
    ap.add_argument("--tf32", action="store_true",
                    help="also run the draws through a TF32-planted K-IRLS")
    ap.add_argument("--parent", metavar="REV",
                    help="also hold every output bit for bit against REV's "
                         "K-IRLS (a git revision or a checkout's directory)")
    ap.add_argument("--label", default="kernel")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dump", metavar="PATH", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("irls_seeds: no CUDA device", file=sys.stderr)
        return 1
    if a.dump:
        dump(a.dump, a.seeds, dev)
        return 0
    result = {a.label: sweep(a.seeds, dev, a.label)}
    rc = 0
    if a.parent:
        result["parent"] = parent_check(a.parent, a.seeds, dev)
        rc = int(any(s["faults"] for s in result["parent"].values()))
    if a.tf32:
        root = _planted_copy()
        env = dict(os.environ, PYTHONPATH=root)
        proc = subprocess.run(
            [sys.executable, "-m", "kmdiff_tpu_torch.tools.irls_seeds",
             "--seeds", str(a.seeds), "--label", "tf32", "--device", a.device],
            cwd=root, env=env, stdout=subprocess.PIPE, text=True, check=True)
        lines = proc.stdout.rstrip("\n").split("\n")
        print("\n".join(lines[:-1]), flush=True)
        result.update(json.loads(lines[-1]))
    print(json.dumps(result))
    return rc


if __name__ == "__main__":
    sys.exit(main())
