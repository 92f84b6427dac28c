"""The port's `count` + `diff` end to end against the JAX package's, on a
simulated cohort (20 kbp genome, 3 controls + 3 cases). The port runs on
the CPU (device="cpu": every kernel wrapper takes its plain twin). The run
directories and every output file must be byte-identical.
"""

import os
import shutil

import pytest
import torch

from kmdiff_tpu.cli import main as jax_main
from kmdiff_tpu.pipeline.simulate import SimOptions, simulate
from kmdiff_tpu_torch.cli import main as torch_main

CORRECTORS = ["bonferroni", "benjamini", "sidak", "holm", "disabled"]


def _files(root):
    out = {}
    for d, _sub, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cohort")
    simulate(SimOptions(output_directory=str(root / "sim"), genome_len=20_000,
                        nb_controls=3, nb_cases=3, seed=5))
    fof = str(root / "sim" / "fof.txt")
    count = ["count", "--file", fof, "--kmer-size", "31", "--hard-min", "1",
             "--nb-partitions", "4", "--threads", "2"]
    assert jax_main([*count, "--run-dir", str(root / "jax_run"),
                     "--devices", "1"]) == 0
    assert torch_main([*count, "--run-dir", str(root / "torch_run")],
                      device="cpu") == 0
    return root


def test_count_run_dirs_byte_identical(cohort):
    jax_files = _files(cohort / "jax_run")
    torch_files = _files(cohort / "torch_run")
    assert sorted(jax_files) == sorted(torch_files)
    names = set(jax_files)
    assert {"kmtricks.fof", "kmdiff-count.opt"} <= names
    assert sum(n.endswith(".kmer.lz4") for n in names) == 4 * 6
    assert sum(n.endswith(".hist") for n in names) == 6
    for name in sorted(names):
        assert torch_files[name] == jax_files[name], name


def _diff_all(main, run_dir, out_dir, **kw):
    """diff once per corrector into one output dir (the merge runs once;
    the resume manifest redoes only the correction), then once with KFF
    output; returns {label: {file: bytes}}."""
    results = {}
    base = ["diff", "--km-run-dir", str(run_dir), "-1", "3", "-2", "3",
            "--output-dir", str(out_dir), "--keep-tmp", "--threads", "2"]
    for corr in CORRECTORS:
        assert main([*base, "--correction", corr], **kw) == 0
        results[corr] = {g: (out_dir / f"{g}_kmers.fasta").read_bytes()
                         for g in ("control", "case")}
    assert main([*base, "--correction", "bonferroni", "--kff-output"], **kw) == 0
    results["kff"] = {g: (out_dir / f"{g}_kmers.kff").read_bytes()
                      for g in ("control", "case")}
    results["options"] = (out_dir / "options.json").read_bytes()
    return results


@pytest.fixture(scope="module")
def diffs(cohort):
    run_dir = cohort / "jax_run"
    ref = _diff_all(jax_main, run_dir, cohort / "jax_out")
    ours = _diff_all(lambda a: torch_main(a, device="cpu"), run_dir,
                     cohort / "torch_out")
    return ref, ours


@pytest.mark.parametrize("corr", CORRECTORS)
def test_diff_fasta_byte_identical(diffs, corr):
    ref, ours = diffs
    assert ours[corr] == ref[corr]
    if corr != "disabled":
        assert ref[corr]["control"] and ref[corr]["case"]


def test_diff_kff_and_manifest_byte_identical(diffs):
    ref, ours = diffs
    assert ours["kff"] == ref["kff"]
    assert ours["options"] == ref["options"]


def test_diff_matrix_run_dir_matches_jax(cohort, tmp_path):
    """A run dir with prebuilt count matrices goes through K-LRT's [B, S]
    tiles (the matrix path); outputs match the JAX package's."""
    from kmdiff_tpu.io.kmtricks import (
        get_partition_paths,
        read_kmer_file,
        write_matrix_file,
    )
    from kmdiff_tpu.pipeline.merge import merge_sorted_streams

    run_dir = tmp_path / "mrun"
    shutil.copytree(cohort / "jax_run", run_dir)
    os.makedirs(run_dir / "matrices")
    for p, paths in enumerate(get_partition_paths(str(run_dir), 4)):
        streams = [read_kmer_file(x)[1:] for x in paths]
        kmers, counts = merge_sorted_streams([s[0] for s in streams],
                                             [s[1] for s in streams])
        write_matrix_file(str(run_dir / "matrices" / f"matrix_{p}.count.lz4"),
                          kmers, counts, 31, p)
    args = ["diff", "--km-run-dir", str(run_dir), "-1", "3", "-2", "3",
            "--significance", "0.5", "--cutoff", "1", "--correction",
            "disabled", "--threads", "2"]
    assert jax_main([*args, "--output-dir", str(tmp_path / "j")]) == 0
    assert torch_main([*args, "--output-dir", str(tmp_path / "t")],
                      device="cpu") == 0
    for g in ("control", "case"):
        want = (tmp_path / "j" / f"{g}_kmers.fasta").read_bytes()
        assert (tmp_path / "t" / f"{g}_kmers.fasta").read_bytes() == want
        assert want


# --distributed runs (tests/test_torch_distributed.py); with an unported
# flag beside it (--devices above 1 is item 7c there) the command raises
# before any process group is opened
@pytest.mark.parametrize("extra", [
    ["--profile", "trace", "--process-id", "0"],
    ["--profile", "trace"],
    ["--distributed", "h:1", "--devices", "2"],
])
def test_unported_diff_flags_raise(cohort, extra, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        torch_main(["diff", "--km-run-dir", str(cohort / "jax_run"), "-1",
                    "3", "-2", "3", "--output-dir", str(tmp_path), *extra],
                   device="cpu")


@pytest.mark.parametrize("extra", [
    ["--profile", "trace"], ["--distributed", "h:1", "--profile", "trace"],
])
def test_unported_run_flags_raise(cohort, extra, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        torch_main(["run", "--file", str(cohort / "sim" / "fof.txt"), "-d",
                    str(tmp_path / "kc"), "-1", "3", "-2", "3", "-o",
                    str(tmp_path / "out"), *extra], device="cpu")
    assert not (tmp_path / "kc").exists()


# --devices N runs the mesh (kmdiff_tpu_torch/parallel/, N CPU shards
# here; --num-processes without a coordinator opens no group): every output
# byte-identical to the same command line with --devices 1
@pytest.mark.parametrize("command, extra", [
    ("diff", ["--devices", "2", "--num-processes", "2"]),
    ("diff", ["--devices", "2"]),
    ("run", ["--devices", "2"]),
])
def test_devices_flags_match_one_device(cohort, command, extra, tmp_path):
    from kmdiff_tpu_torch.parallel import runtime

    if command == "diff":
        argv = ["diff", "--km-run-dir", str(cohort / "jax_run"), "-1", "3",
                "-2", "3", "-s", "0.5", "--cutoff", "1", "-c", "disabled"]
    else:
        argv = ["run", "--file", str(cohort / "sim" / "fof.txt"), "-k", "31",
                "--nb-partitions", "4", "-1", "3", "-2", "3", "-s", "0.5",
                "--cutoff", "1", "-c", "disabled"]
    trees = []
    for tag, flags in (("one", ["--devices", "1"]), ("mesh", extra)):
        out = tmp_path / tag
        rd = ["-d", str(tmp_path / f"kc_{tag}")] if command == "run" else []
        assert torch_main([*argv, *rd, "-o", str(out), *flags],
                          device="cpu") == 0
        assert runtime.get_mesh(torch.device("cpu")).size == 1  # for the command only
        trees.append(_files(out))
        if command == "run":
            trees.append(_files(tmp_path / f"kc_{tag}"))
    assert trees[0]["case_kmers.fasta"] and trees[0]["control_kmers.fasta"]
    assert trees[: len(trees) // 2] == trees[len(trees) // 2 :]


def test_unported_commands_and_k_raise(tmp_path):
    # k from 8 to 128 runs; outside that range the CLI rejects the value as
    # the JAX CLI does
    for k in ("7", "129"):
        args = ["count", "--file", "f", "--run-dir", str(tmp_path), "--kmer-size", k]
        for main in (jax_main, lambda a: torch_main(a, device="cpu")):
            with pytest.raises(SystemExit) as e:
                main(args)
            assert e.value.code == 2
    with pytest.raises(NotImplementedError):
        torch_main(["warmup", "-1", "1", "-2", "1"], device="cpu")


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_main(["infos"])


def test_popsim_matches_jax(tmp_path):
    args = ["popsim", "--genome-len", "3000", "-1", "1", "-2", "1",
            "--random-seed", "3"]
    assert jax_main([*args, "-o", str(tmp_path / "j")]) == 0
    assert torch_main([*args, "-o", str(tmp_path / "t")], device="cpu") == 0
    for name in ("control_0.fasta", "case_1.fasta", "truth.fasta"):
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes())
