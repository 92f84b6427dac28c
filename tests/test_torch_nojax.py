"""The port never imports JAX or the JAX package: in a fresh interpreter
that refuses and records every import of `jax`, `jaxlib` or `kmdiff_tpu`
(the exact top-level name, not `kmdiff_tpu_torch`), kmdiff_tpu_torch
simulates, counts, diffs and runs (the fused count -> diff) a tiny cohort on
the CPU, then diffs and runs it again with population-stratification
correction and --save-sk, diffs it with the port's device plugin
(process_block_torch), maps the case k-mers with `call` and prints `infos`,
and no such import was even attempted (on a machine where JAX is installed,
an attempt would load it), and then counts, popstrat-diffs and runs it on
a two-shard mesh (`--devices 2`: parallel/mesh.py, runtime.py,
count_step.py, merge_step.py, diff_step.py). The same holds for each rank
of a two-rank `--distributed` count and popstrat diff (parallel/). Neither the port's
sources (its example plugins and parallel/ among them) nor chip_smoke.py
hold an import line of either."""

import json
import os
import pathlib
import re
import subprocess
import sys
import textwrap

PORT = pathlib.Path(__file__).resolve().parents[1] / "kmdiff_tpu_torch"

_BLOCK = textwrap.dedent("""
    import importlib.abc
    import os
    import sys

    attempts = []

    BLOCKED = ("jax", "jaxlib", "kmdiff_tpu")

    class BlockJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                attempts.append(name)
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, BlockJax())
""")

_SCRIPT = _BLOCK + textwrap.dedent("""
    from kmdiff_tpu_torch.cli import main

    root = sys.argv[1]
    assert main(["popsim", "-o", os.path.join(root, "sim"), "--genome-len",
                 "4000", "-1", "2", "-2", "2", "--random-seed", "1"],
                device="cpu") == 0
    assert main(["count", "--file", os.path.join(root, "sim", "fof.txt"),
                 "--run-dir", os.path.join(root, "run"), "--kmer-size", "21",
                 "--threads", "1"], device="cpu") == 0
    assert main(["diff", "--km-run-dir", os.path.join(root, "run"),
                 "-1", "2", "-2", "2", "--output-dir", os.path.join(root, "out"),
                 "--threads", "1"], device="cpu") == 0
    assert os.path.exists(os.path.join(root, "out", "case_kmers.fasta"))
    assert main(["run", "--file", os.path.join(root, "sim", "fof.txt"),
                 "-d", os.path.join(root, "run_f"), "-k", "21", "-1", "2",
                 "-2", "2", "-o", os.path.join(root, "out_f"),
                 "--threads", "1"], device="cpu") == 0
    for name in ("control_kmers.fasta", "case_kmers.fasta", "options.json"):
        with open(os.path.join(root, "out", name), "rb") as a, \
                open(os.path.join(root, "out_f", name), "rb") as b:
            assert a.read() == b.read(), name
    pop = ["-1", "2", "-2", "2", "-s", "0.5", "--cutoff", "1",
           "--pop-correction", "--kmer-pca", "0.05", "--threads", "1"]
    assert main(["diff", "--km-run-dir", os.path.join(root, "run"), *pop,
                 "--save-sk", "--output-dir", os.path.join(root, "out_p")],
                device="cpu") == 0
    assert main(["run", "--file", os.path.join(root, "sim", "fof.txt"),
                 "-d", os.path.join(root, "run_p"), "-k", "21", *pop,
                 "-o", os.path.join(root, "out_pf")], device="cpu") == 0
    for out in ("out_p", "out_pf"):
        assert os.path.exists(os.path.join(root, out, "popstrat", "pcs.evec"))
    assert os.listdir(os.path.join(root, "out_p", "positive_kmer_matrix",
                                   "matrices"))
    plugin = os.path.join(os.path.dirname(sys.argv[2]), "examples", "plugins",
                          "device_fold_change_model.py")
    assert main(["diff", "--km-run-dir", os.path.join(root, "run"), "-1", "2",
                 "-2", "2", "-s", "0.5", "--cutoff", "1", "-c", "disabled",
                 "--model", plugin, "--pop-correction", "--threads", "1",
                 "--output-dir", os.path.join(root, "out_m")],
                device="cpu") == 0
    case = os.path.join(root, "out_m", "case_kmers.fasta")
    assert os.path.getsize(case) > 0
    assert not os.path.exists(os.path.join(root, "out_m", "popstrat"))
    assert main(["call", "-i", case, "-r",
                 os.path.join(root, "sim", "case_3.fasta"), "-o",
                 os.path.join(root, "calls.tsv")], device="cpu") == 0
    with open(os.path.join(root, "calls.tsv")) as f:
        assert len(f.read().splitlines()) > 1
    assert main(["infos"], device="cpu") == 0
    # the mesh runtime (parallel/), on two CPU shards: count, diff with
    # popstrat and the fused run
    for command in (
            ["count", "--file", os.path.join(root, "sim", "fof.txt"),
             "--run-dir", os.path.join(root, "run_m"), "--kmer-size", "21",
             "--threads", "1"],
            ["diff", "--km-run-dir", os.path.join(root, "run_m"), *pop,
             "--output-dir", os.path.join(root, "out_mp")],
            ["run", "--file", os.path.join(root, "sim", "fof.txt"),
             "-d", os.path.join(root, "run_mf"), "-k", "21", "-1", "2",
             "-2", "2", "-o", os.path.join(root, "out_mf"), "--threads", "1"]):
        assert main([*command, "--devices", "2"], device="cpu") == 0
    for name in ("control_kmers.fasta", "case_kmers.fasta"):
        with open(os.path.join(root, "out", name), "rb") as a, \
                open(os.path.join(root, "out_mf", name), "rb") as b:
            assert a.read() == b.read(), name
    # the sharded LR filter of count-matrix blocks (the matrix path's)
    import numpy as np
    import torch
    from kmdiff_tpu_torch.parallel.diff_step import make_sharded_diff_step
    from kmdiff_tpu_torch.parallel.mesh import make_mesh

    step = make_sharded_diff_step(make_mesh(2, torch.device("cpu")), 1)
    assert step(np.ones((4, 2), np.int32), 0.5, 0.5, 0.0)[4][0] == 4
    for mod in ("mesh", "runtime", "count_step", "merge_step", "diff_step"):
        assert f"kmdiff_tpu_torch.parallel.{mod}" in sys.modules, mod
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    assert not attempts, attempts
    print("NOJAX_OK")
""")


_RANK_SCRIPT = _BLOCK + textwrap.dedent("""
    import json

    from kmdiff_tpu_torch.cli import main

    for argv, port in json.loads(sys.argv[1]):
        os.environ["KMDIFF_COORDINATOR"] = f"127.0.0.1:{port}"
        assert main(argv, device="cpu") == 0, argv
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    assert not attempts, attempts
    assert "kmdiff_tpu_torch.parallel.distributed" in sys.modules
    print("RANK_OK", flush=True)
""")


def test_distributed_ranks_run_with_jax_blocked(tmp_path):
    from kmdiff_tpu_torch.cli import main as torch_main
    from test_torch_distributed import run_ranks

    sim, run, out = tmp_path / "sim", tmp_path / "run", tmp_path / "out"
    assert torch_main(["popsim", "-o", str(sim), "--genome-len", "4000", "-1",
                       "2", "-2", "2", "--random-seed", "1"], device="cpu") == 0
    commands = [
        ["count", "--file", str(sim / "fof.txt"), "--run-dir", str(run),
         "--kmer-size", "21", "--threads", "1"],
        ["diff", "--km-run-dir", str(run), "-1", "2", "-2", "2", "-s", "0.5",
         "--cutoff", "1", "--pop-correction", "--kmer-pca", "0.05",
         "--threads", "1", "--output-dir", str(out)],
    ]
    run_ranks(_RANK_SCRIPT, commands, tmp_path / "logs")
    assert (out / "popstrat" / "pcs.evec").exists()
    assert (out / "case_kmers.fasta").exists()


def test_port_runs_with_jax_blocked(tmp_path):
    env = dict(os.environ)
    # without these, kmdiff_tpu/__init__ would import JAX for its
    # compile-cache set-up, were it ever imported
    env.pop("JAX_PLATFORMS", None)
    env.pop("KMDIFF_NO_JAX_CACHE", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(PORT.parent), env.get("PYTHONPATH", "")]
    )
    res = subprocess.run([sys.executable, "-c", _SCRIPT, str(tmp_path),
                          str(PORT / "__init__.py")],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "NOJAX_OK" in res.stdout
    assert "kmdiff-tpu-torch " in res.stdout  # infos


def test_port_sources_never_import_jax():
    pattern = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|kmdiff_tpu)(\.|\s|$)",
                         re.MULTILINE)
    assert pattern.search("    from kmdiff_tpu.io import lz4\n")
    assert not pattern.search("from kmdiff_tpu_torch import kernels\n")
    sources = [*sorted(PORT.rglob("*.py")), PORT.parent / "chip_smoke.py"]
    assert len(sources) >= 12
    assert PORT / "examples" / "plugins" / "device_fold_change_model.py" in sources
    for name in ("distributed", "mesh", "runtime", "count_step", "merge_step",
                 "diff_step"):
        assert PORT / "parallel" / f"{name}.py" in sources, name
    for path in sources:
        assert not pattern.search(path.read_text()), path
