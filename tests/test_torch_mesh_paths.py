"""The mesh paths that tests/test_torch_mesh.py's five commands leave out,
on two CPU shards (--devices 2) against one shard (--devices 1) and the JAX
CLI's --devices 8 (conftest's eight virtual CPU devices), on that file's
cohort (popsim's 3 + 3 samples of a 20 kbp genome, seed 5):

- at k = 63 (two-word keys): the loose `diff`, popstrat `diff --save-sk`
  and the fused `run`, so a merge at k > 32 runs on each shard;
- `run --pop-correction --kmer-pca 0.05 --save-sk` at k = 31 (popstrat's
  fused full merge and its alt fits under a mesh);
- `diff --model` with the port's numpy fold-change twin at k = 31 (the
  JAX CLI with its own example, which the twin matches byte for byte);
- the loose `diff` at k = 31 with LrtParams.wide_sums forced true (the wide
  full merge, int64 sums; tests/test_torch_wide.py's _force_wide).

Every output is byte-identical to one shard's. Against the JAX CLI the
FASTA, options.json, popstrat's pcs.evec and the --save-sk matrices are
byte-identical, as tests/test_torch_mesh.py's popstrat case holds them
(at 3 + 3 samples popstrat's alt fits separate and its FASTA are empty;
its merge's --save-sk matrices and geno rows are not).
"""

import os
import pathlib

import pytest

from kmdiff_tpu.cli import main as jax_main
from kmdiff_tpu.pipeline.simulate import SimOptions, simulate
from kmdiff_tpu_torch.cli import main as torch_main
from kmdiff_tpu_torch.ops import merge_dev
from kmdiff_tpu_torch.parallel import runtime
from kmdiff_tpu_torch.pipeline import count as tcount
from kmdiff_tpu_torch.pipeline import merge as tmerge

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_MODEL = REPO / "kmdiff_tpu_torch" / "examples" / "plugins" / "fold_change_model.py"
JAX_MODEL = REPO / "examples" / "plugins" / "fold_change_model.py"
FASTA = ("control_kmers.fasta", "case_kmers.fasta")
LOOSE = ["-1", "3", "-2", "3", "-s", "0.5", "--cutoff", "1", "-c", "disabled",
         "--threads", "2"]
POP = ["--pop-correction", "--kmer-pca", "0.05", "--save-sk"]
COUNT = ["--nb-partitions", "4", "--threads", "2"]


@pytest.fixture(autouse=True)
def _reset_port_runtime():
    yield
    runtime.configure(None)


def _files(root) -> dict:
    out = {}
    for d, _sub, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _commands(root: pathlib.Path, tag: str, model: pathlib.Path) -> dict:
    """The commands held across shard counts, outputs under root/<name>_<tag>,
    on the run directories root/count31 and root/count63."""
    fof = str(root / "sim" / "fof.txt")

    def out(name):
        return ["--output-dir", str(root / f"{name}_{tag}")]

    rd31, rd63 = str(root / "count31"), str(root / "count63")
    return {
        "diff63": ["diff", "--km-run-dir", rd63, *LOOSE, *out("diff63")],
        "popstrat63": ["diff", "--km-run-dir", rd63, *LOOSE, *POP,
                       *out("popstrat63")],
        "run63": ["run", "--file", fof, "-k", "63", *COUNT, *LOOSE, "--run-dir",
                  str(root / f"runrd63_{tag}"), *out("run63")],
        "poprun31": ["run", "--file", fof, "-k", "31", *COUNT, *LOOSE, *POP,
                     "--run-dir", str(root / f"poprunrd31_{tag}"),
                     *out("poprun31")],
        "model31": ["diff", "--km-run-dir", rd31, *LOOSE, "--model", str(model),
                    *out("model31")],
    }


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The run directories (k = 31 and 63, one shard), then every command
    through the port's CLI at one and two shards and through the JAX CLI at
    --devices 8."""
    root = tmp_path_factory.mktemp("mesh_paths")
    simulate(SimOptions(output_directory=str(root / "sim"), genome_len=20_000,
                        nb_controls=3, nb_cases=3, seed=5))
    for k in (31, 63):
        assert torch_main(["count", "--file", str(root / "sim" / "fof.txt"),
                           "-k", str(k), *COUNT, "--run-dir",
                           str(root / f"count{k}"), "--devices", "1"],
                          device="cpu") == 0
    for D in (1, 2):
        for argv in _commands(root, f"t{D}", PORT_MODEL).values():
            assert torch_main([*argv, "--devices", str(D)], device="cpu") == 0
    for argv in _commands(root, "j8", JAX_MODEL).values():
        assert jax_main([*argv, "--devices", "8"]) == 0
    return root


MATRICES = tuple(f"positive_kmer_matrix/matrices/matrix_{p}.count.lz4"
                 for p in range(4))


@pytest.mark.parametrize("command", ["diff63", "popstrat63", "run63",
                                     "poprun31", "model31"])
def test_mesh_path_matches_one_shard_and_jax(cli_runs, command):
    root = cli_runs
    two, one = _files(root / f"{command}_t2"), _files(root / f"{command}_t1")
    assert sorted(two) == sorted(one)
    for name in one:
        assert two[name] == one[name], name
    if not command.startswith("pop"):
        # (at 3 + 3 samples popstrat's alt fits separate: p = 1, empty
        # FASTA; its matrices and geno rows are what the merge wrote)
        assert one["case_kmers.fasta"] and one["control_kmers.fasta"]
    if command.startswith("run"):
        # the fused run's count files, as count + diff's
        rd = command.replace("run", "runrd")
        assert _files(root / f"{rd}_t2") == _files(root / f"{rd}_t1")
    names = [*FASTA]
    if command != "model31":
        names.append("options.json")
    if command.startswith("pop"):
        names += ["popstrat/pcs.evec", "popstrat/gwas_eigenstratX.geno",
                  *MATRICES]
        assert all(one[m] for m in MATRICES)
        assert one["popstrat/gwas_eigenstratX.geno"]
    jax = _files(root / f"{command}_j8")
    for name in names:
        assert one[name] == jax[name], name


def test_run63_equals_diff63(cli_runs):
    """The fused run at k = 63 on two shards: the FASTA of the loose diff
    of count + diff."""
    root = cli_runs
    for name in FASTA:
        assert ((root / "run63_t2" / name).read_bytes()
                == (root / "diff63_t1" / name).read_bytes()), name


def _force_wide(monkeypatch) -> dict:
    """LrtParams.wide_sums true in this process, in the port
    (tests/test_torch_wide.py's _force_wide); counts the full merges and
    fails on a packed merge or a host group pre-sum."""
    base = tmerge.LrtParams

    class Wide(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.wide_sums = True

    calls = {"full": 0}
    full = merge_dev.merge_lrt_full

    def spy(*a, **k):
        calls["full"] += 1
        return full(*a, **k)

    def packed(*_a, **_k):
        raise AssertionError("a wide cohort took the packed merge")

    monkeypatch.setattr(tmerge, "LrtParams", Wide)
    monkeypatch.setattr(merge_dev, "merge_lrt_full", spy)
    monkeypatch.setattr(merge_dev, "merge_lrt", packed)
    monkeypatch.setattr(tcount, "_merge_streams", packed)
    return calls


def test_wide_diff_mesh_matches_one_shard(cli_runs, tmp_path, monkeypatch):
    argv = ["diff", "--km-run-dir", str(cli_runs / "count31"), *LOOSE]
    assert torch_main([*argv, "--output-dir", str(tmp_path / "narrow"),
                       "--devices", "1"], device="cpu") == 0
    calls = _force_wide(monkeypatch)
    outs = []
    for D in (1, 2):
        before = calls["full"]
        out = tmp_path / f"wide{D}"
        assert torch_main([*argv, "--output-dir", str(out), "--devices", str(D)],
                          device="cpu") == 0
        # a merge a partition, one a shard on the mesh
        assert calls["full"] - before == 4 * D
        outs.append(_files(out))
    assert sorted(outs[0]) == sorted(outs[1])
    for name in outs[0]:
        assert outs[0][name] == outs[1][name], name
    # the int64 sums give the narrow merge's FASTA
    for name in FASTA:
        assert outs[1][name] == (tmp_path / "narrow" / name).read_bytes() != b""
