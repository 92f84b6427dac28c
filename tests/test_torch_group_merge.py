"""KMDIFF_GROUP_MERGE=1 on the port's `run`: accepted and ignored.

The JAX package's `run` with the variable folds the controls' and the
cases' resident streams into group streams before the merge
(kmdiff_tpu/pipeline/fused.py::GroupReducer); its sums are exact, so its
outputs are those of the per-sample merge. The port's `run` merges the
per-sample streams whatever the variable says. On the simulated 3 + 3
cohort of tests/test_torch_fused.py, in four cases (the defaults, the JAX
reducer's chunked path with the SORT_CEILING and CHUNK_ROWS of
tests/test_fused.py, k = 63, and --devices 2 against the JAX CLI's
--devices 8), the port's `run` with the variable writes FASTA, count files
and histograms byte-identical to the JAX `run` with it and to the port's
`run` without it, and fused_merge is given the six sample streams.
"""

import os

import pytest

import kmdiff_tpu.pipeline.fused as jfused
from kmdiff_tpu.cli import main as jax_main
from kmdiff_tpu.pipeline.simulate import SimOptions, simulate
from kmdiff_tpu_torch.cli import main as torch_main
from kmdiff_tpu_torch.cmd import run as trun
from kmdiff_tpu_torch.parallel import runtime
from kmdiff_tpu_torch.pipeline import fused

FASTA = ("control_kmers.fasta", "case_kmers.fasta")


def _files(root):
    out = {}
    for d, _sub, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _run_dir_files(root):
    """The count files and histograms of a run directory."""
    return {n: b for n, b in _files(root).items()
            if n.startswith(("counts", "histograms"))}


@pytest.fixture(scope="module")
def fof(tmp_path_factory):
    root = tmp_path_factory.mktemp("group_cohort")
    simulate(SimOptions(output_directory=str(root / "sim"), genome_len=20_000,
                        nb_controls=3, nb_cases=3, seed=5))
    return str(root / "sim" / "fof.txt")


@pytest.fixture(autouse=True)
def _reset_port_runtime():
    yield
    runtime.configure(None)


def _args(fof, root, extra=()):
    return ["run", "--file", fof, "-d", str(root / "kc"), "-o",
            str(root / "out"), "-k", "31", "-1", "3", "-2", "3",
            "--nb-partitions", "4", "--threads", "2", *extra]


#: case -> (the command's extra flags, port patches, JAX patches, the port's
#: and the JAX CLI's --devices)
CASES = {
    "defaults": ([], {}, {"CHUNK_ROWS": 1 << 15}, "1", "1"),
    "chunked": ([], {"FUSED_CHUNK_ROWS": 1 << 13},
                {"SORT_CEILING": 1 << 13, "CHUNK_ROWS": 1 << 9}, "1", "1"),
    "k63": (["-k", "63"], {}, {"CHUNK_ROWS": 1 << 15}, "1", "1"),
    "devices2": ([], {}, {"CHUNK_ROWS": 1 << 15}, "2", "8"),
}


def _port_run(fof, root, case, group: bool):
    """The port's run of a case with KMDIFF_GROUP_MERGE set to 1 or 0, on
    the fused path; returns the number of streams of each fused_merge
    call."""
    flags, port_patch, _jp, port_dev, _jd = CASES[case]
    seen = []
    real = fused.fused_merge

    def spy(processor, accs, streams, *a, **k):
        seen.append(len(streams))
        return real(processor, accs, streams, *a, **k)

    def boom(*_a, **_k):
        raise AssertionError("the fused path fell back to the standard flow")

    with pytest.MonkeyPatch.context() as mp:
        for name, value in port_patch.items():
            mp.setattr(fused, name, value)
        mp.setenv("KMDIFF_GROUP_MERGE", "1" if group else "0")
        mp.setattr(trun, "_standard_flow", boom)
        mp.setattr(fused, "fused_merge", spy)
        assert torch_main([*_args(fof, root, flags), "--devices", port_dev],
                          device="cpu") == 0
    return seen


@pytest.fixture(scope="module")
def reference(fof, tmp_path_factory):
    """Every case's JAX `run` with the variable and the port's without it,
    once a module."""
    import kmdiff_tpu.cmd.run as jrun

    root = tmp_path_factory.mktemp("group_refs")
    for case, (extra, _pp, jax_patch, _pd, jax_dev) in CASES.items():
        with pytest.MonkeyPatch.context() as mp:
            for name, value in jax_patch.items():
                mp.setattr(jfused, name, value)
            mp.setenv("KMDIFF_GROUP_MERGE", "1")

            def boom(*_a, **_k):
                raise AssertionError("the JAX run fell back")

            mp.setattr(jrun, "_standard_flow", boom)
            assert jax_main([*_args(fof, root / f"j_{case}", extra), "--devices",
                             jax_dev]) == 0
        assert _port_run(fof, root / f"t_{case}", case, group=False) == [6]
    return root


@pytest.mark.parametrize("case", list(CASES))
def test_group_merge_run_matches_jax_and_the_plain_run(fof, reference, tmp_path,
                                                       case):
    # the variable makes no group streams: the six sample streams merge
    assert _port_run(fof, tmp_path, case, group=True) == [6]
    ours = _files(tmp_path / "out")
    jax_, plain = (_files(reference / f"{w}_{case}" / "out") for w in "jt")
    assert ours["case_kmers.fasta"] and ours["control_kmers.fasta"]
    for name in FASTA:
        assert ours[name] == jax_[name] == plain[name], name
    rd = _run_dir_files(tmp_path / "kc")
    assert sum(n.endswith(".kmer.lz4") for n in rd) == 4 * 6
    assert rd == _run_dir_files(reference / f"j_{case}" / "kc")
    assert rd == _run_dir_files(reference / f"t_{case}" / "kc")
