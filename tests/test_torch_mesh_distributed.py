"""The mesh under the multi-process runtime (--devices N beside
--distributed): two spawned gloo ranks, each on a mesh of two CPU shards,
through tests/test_torch_distributed.py's worker harness (a wall-clock limit
a rank, a gloo timeout, both ranks killed when one fails), held against the
port's one process on one shard (--devices 1) and, for the k = 31 FASTA,
against the JAX package's single process.

- `count` and the loose `diff` at k = 31 and at k = 45 (two words);
- popstrat `diff --save-sk` on tests/test_torch_distributed.py's
  stratified cohort (byte-identical: a partition is corrected on one rank,
  and CPU shards fit a block whole);
- `run --distributed` (the standard count + diff flow);
- the card arithmetic of a rank's mesh (parallel.distributed.rank_cards),
  and its refusal on a machine with too few cards.

The other commands' cohort is tests/test_torch_mesh.py's: popsim's 3 + 3
samples of a 20 kbp genome, seed 5.
"""

import os
import pathlib

import pytest

from kmdiff_tpu.cli import main as jax_main
from kmdiff_tpu.pipeline.simulate import SimOptions, simulate
from kmdiff_tpu_torch.cli import main as torch_main
from kmdiff_tpu_torch.parallel.distributed import rank_cards
from test_torch_distributed import (  # noqa: F401 (stratified: a fixture)
    _count_args,
    _pop_args,
    run_cli_ranks,
    stratified,
)

FASTA = ("control_kmers.fasta", "case_kmers.fasta")
LOOSE = ["-1", "3", "-2", "3", "-s", "0.5", "--cutoff", "1", "-c", "disabled",
         "--threads", "2"]


def _files(root: pathlib.Path) -> dict:
    out = {}
    for d, _sub, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _commands(root: pathlib.Path, tag: str, fof: str, pop_fof) -> dict:
    """The commands held against one process, outputs under root/<name>_<tag>;
    popstrat on the stratified cohort of pop_fof."""
    count = ["--file", fof, "--nb-partitions", "4", "--threads", "2"]

    def rd(k):
        return str(root / f"count{k}_{tag}")

    return {
        "count31": ["count", *count, "-k", "31", "--run-dir", rd(31)],
        "diff31": ["diff", "--km-run-dir", rd(31), *LOOSE, "--output-dir",
                   str(root / f"diff31_{tag}")],
        "count45": ["count", *count, "-k", "45", "--run-dir", rd(45)],
        "diff45": ["diff", "--km-run-dir", rd(45), *LOOSE, "--output-dir",
                   str(root / f"diff45_{tag}")],
        "popcount": _count_args(pop_fof, root / f"popcount_{tag}", 21),
        "popstrat": _pop_args(root / f"popcount_{tag}", root / f"popstrat_{tag}",
                              "disabled"),
        "run": ["run", *count, "-k", "31", *LOOSE, "--run-dir",
                str(root / f"runrd_{tag}"), "--output-dir",
                str(root / f"run_{tag}")],
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory, stratified):
    """Every command as two ranks x two CPU shards, as one process on one
    shard, and (count + diff at k = 31) through the JAX CLI."""
    root = tmp_path_factory.mktemp("mesh_dist")
    simulate(SimOptions(output_directory=str(root / "sim"), genome_len=20_000,
                        nb_controls=3, nb_cases=3, seed=5))
    fof, pop_fof = str(root / "sim" / "fof.txt"), stratified / "fof.txt"
    for argv in _commands(root, "one", fof, pop_fof).values():
        assert torch_main([*argv, "--devices", "1"], device="cpu") == 0
    jax = _commands(root, "jax", fof, pop_fof)
    for name in ("count31", "diff31"):
        assert jax_main([*jax[name], "--devices", "1"]) == 0
    outs = run_cli_ranks([[*argv, "--devices", "2"] for argv in
                          _commands(root, "ranks", fof, pop_fof).values()],
                         root / "logs")
    return root, outs


def test_each_rank_ran_a_two_shard_mesh(runs):
    _root, outs = runs
    for r, out in enumerate(outs):
        assert "mesh: 2 shards on cpu, cpu" in out, r
        assert f"process {r}/2" in out
    assert "owns partitions [0, 2]" in outs[0]
    assert "owns partitions [1, 3]" in outs[1]
    assert "popstrat corrected partitions [0, 2, 4]" in outs[0]
    assert "popstrat corrected partitions [1, 3]" in outs[1]


@pytest.mark.parametrize("name", ["count31", "diff31", "count45", "diff45",
                                  "popcount", "popstrat", "run"])
def test_two_ranks_of_two_shards_match_one_process(runs, name):
    root, _outs = runs
    ours, one = _files(root / f"{name}_ranks"), _files(root / f"{name}_one")
    if name.startswith("count"):
        assert sum(n.endswith(".kmer.lz4") for n in one) == 4 * 6
    elif name == "popcount":
        assert sum(n.endswith(".kmer.lz4") for n in one) == 5 * 20
    else:
        assert one["case_kmers.fasta"] and one["control_kmers.fasta"]
    if name == "popstrat":
        assert "popstrat/pcs.evec" in one
        assert sum("matrices/matrix_" in n for n in one) == 5
        # the per-rank geno parts are the distributed run's own files
        ours = {n: b for n, b in ours.items() if "geno_part" not in n}
    assert sorted(ours) == sorted(one)
    for n in one:
        assert ours[n] == one[n], n
    if name == "run":
        assert _files(root / "runrd_ranks") == _files(root / "runrd_one")


def test_k31_matches_the_jax_package(runs):
    root, _outs = runs
    jax_run, ours = _files(root / "count31_jax"), _files(root / "count31_ranks")
    assert sorted(jax_run) == sorted(ours)
    assert all(ours[n] == jax_run[n] for n in jax_run)
    for name in FASTA:
        want = (root / "diff31_jax" / name).read_bytes()
        assert (root / "diff31_ranks" / name).read_bytes() == want != b""


@pytest.mark.parametrize("cards, shards, virtual, want", [
    # one shard a rank (0 or 1): cuda:(r mod cards), as without a mesh
    (1, 0, False, [[0], [0], [0]]),
    (4, 1, False, [[0], [1], [2], [3], [0]]),
    (2, 0, False, [[0], [1], [0]]),
    # a mesh of N cards a rank, from cuda:(r N mod cards) on
    (4, 2, False, [[0, 1], [2, 3], [0, 1]]),
    (8, 4, False, [[0, 1, 2, 3], [4, 5, 6, 7]]),
    (4, 4, False, [[0, 1, 2, 3], [0, 1, 2, 3]]),
    # a virtual mesh repeats the rank's one card
    (1, 2, True, [[0], [0]]),
    (4, 2, True, [[0], [1], [2], [3]]),
])
def test_rank_cards(cards, shards, virtual, want):
    assert [rank_cards(r, shards, cards, virtual) for r in range(len(want))] == want


@pytest.mark.parametrize("r, cards, shards, match", [
    (0, 1, 2, "rank 0 needs cuda:0-1, the machine has 1"),
    (1, 3, 2, "rank 1 needs cuda:2-3, the machine has 3"),
    (1, 6, 4, "rank 1 needs cuda:4-7, the machine has 6"),
])
def test_rank_cards_refuses_too_few_cards(r, cards, shards, match):
    with pytest.raises(ValueError, match=match):
        rank_cards(r, shards, cards)
