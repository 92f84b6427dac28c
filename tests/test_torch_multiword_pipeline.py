"""The port's `count` + `diff` at k > 32 (multi-word k-mers) end to end
against the JAX package's, on the CPU (every kernel wrapper takes its plain
twin), on a simulated cohort (20 kbp genome, 150 bp reads, 3 controls + 3
cases) at k = 33, 55, 64 and 128: run directories (count files,
histograms) and every diff output byte-identical.
"""

import os

import pytest

from kmdiff_tpu.cli import main as jax_main
from kmdiff_tpu.pipeline.simulate import SimOptions, simulate
from kmdiff_tpu_torch.cli import main as torch_main

KS = [33, 55, 64, 128]


def _files(root):
    out = {}
    for d, _sub, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    root = tmp_path_factory.mktemp("mw_cohort")
    simulate(SimOptions(output_directory=str(root / "sim"), genome_len=20_000,
                        nb_controls=3, nb_cases=3, read_size=150, seed=5))
    return root


@pytest.fixture(scope="module", params=KS)
def counted(sim, request):
    k = request.param
    fof = str(sim / "sim" / "fof.txt")
    count = ["count", "--file", fof, "--kmer-size", str(k), "--hard-min", "1",
             "--nb-partitions", "4", "--threads", "2"]
    jax_run, torch_run = sim / f"jax_run_{k}", sim / f"torch_run_{k}"
    assert jax_main([*count, "--run-dir", str(jax_run), "--devices", "1"]) == 0
    assert torch_main([*count, "--run-dir", str(torch_run)], device="cpu") == 0
    return k, jax_run, torch_run


def test_count_run_dirs_byte_identical(counted):
    k, jax_run, torch_run = counted
    want, got = _files(jax_run), _files(torch_run)
    assert sorted(got) == sorted(want)
    assert sum(n.endswith(".kmer.lz4") for n in want) == 4 * 6
    assert sum(n.endswith(".hist") for n in want) == 6
    for name in sorted(want):
        assert got[name] == want[name], (k, name)


@pytest.mark.parametrize("cut", ["defaults", "loose"])
def test_diff_outputs_byte_identical(counted, tmp_path, cut):
    """The port's diff on the JAX run directory (the packed merge after the
    host pre-sum): FASTA and options.json as the JAX diff writes them;
    the loose cut keeps thousands of k-mers, also as KFF."""
    k, jax_run, _torch_run = counted
    extra = {"defaults": [],
             "loose": ["-s", "0.5", "--cutoff", "1", "-c", "disabled",
                       "--kff-output"]}[cut]
    args = ["diff", "--km-run-dir", str(jax_run), "-1", "3", "-2", "3",
            "--threads", "2", *extra]
    assert jax_main([*args, "--output-dir", str(tmp_path / "j")]) == 0
    assert torch_main([*args, "--output-dir", str(tmp_path / "t")],
                      device="cpu") == 0
    names = (["control_kmers.kff", "case_kmers.kff"] if cut == "loose" else
             ["control_kmers.fasta", "case_kmers.fasta"])
    for name in [*names, "options.json"]:
        want = (tmp_path / "j" / name).read_bytes()
        assert (tmp_path / "t" / name).read_bytes() == want, (k, name)
    if cut == "loose":
        assert (tmp_path / "j" / "case_kmers.kff").stat().st_size > 1000


def test_diff_of_the_port_run_dir_and_chunked_merge(counted, tmp_path, monkeypatch):
    """The port's own run directory through the port's diff, with the
    partitions cut into key-range chunks on their leading word
    (MAX_DEVICE_ROWS lowered), against the JAX diff: FASTA byte-identical."""
    from kmdiff_tpu_torch.pipeline import merge as tmerge

    k, jax_run, torch_run = counted
    monkeypatch.setattr(tmerge, "MAX_DEVICE_ROWS", 3000)
    args = ["-1", "3", "-2", "3", "-s", "0.5", "--cutoff", "1", "-c",
            "disabled", "--threads", "2"]
    assert jax_main(["diff", "--km-run-dir", str(jax_run), *args,
                     "--output-dir", str(tmp_path / "j")]) == 0
    assert torch_main(["diff", "--km-run-dir", str(torch_run), *args,
                       "--output-dir", str(tmp_path / "t")], device="cpu") == 0
    for g in ("control", "case"):
        want = (tmp_path / "j" / f"{g}_kmers.fasta").read_bytes()
        assert (tmp_path / "t" / f"{g}_kmers.fasta").read_bytes() == want, (k, g)
        assert want
