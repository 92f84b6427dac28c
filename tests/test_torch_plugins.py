"""The port's custom model plugins (`--model`) against the JAX package's.

The port's twins of the JAX example plugins (kmdiff_tpu_torch/examples/
plugins/) run through the port's CLI on the CPU (device="cpu": the device
twin's process_block_torch gets CPU tiles), the JAX examples through the
JAX CLI, on the same run directories: the reference fixture (1 + 1) and a
simulated cohort (3 + 3) counted at k = 31 and k = 63. FASTA files and
--save-sk matrices must be byte-identical, k-mers tested and tallies equal:
no tolerance. Also: the host union merge against the JAX one, a scalar-only
plugin, prebuilt matrices, tiles across BLOCK_ROWS, `run --model`,
`--model --pop-correction`, the loader's specs and refusals, and `infos`.
"""

import json
import logging
import os
import pathlib
import shutil
import textwrap

import numpy as np
import pytest
import torch

from kmdiff_tpu.cli import main as jax_main
from kmdiff_tpu.cmd.diff import main_diff as jax_main_diff
from kmdiff_tpu.cmd.options import DiffOptions as JaxDiffOptions
from kmdiff_tpu.core.corrector import CorrectionType as JaxCorrection
from kmdiff_tpu.io import kmtricks as jkm
from kmdiff_tpu.pipeline import merge as jmerge
from kmdiff_tpu.pipeline.simulate import SimOptions, simulate
from kmdiff_tpu_torch.cli import main as torch_main
from kmdiff_tpu_torch.cmd.diff import main_diff as torch_main_diff
from kmdiff_tpu_torch.cmd.options import DiffOptions
from kmdiff_tpu_torch.core.corrector import CorrectionType
from kmdiff_tpu_torch.core.model import IModel
from kmdiff_tpu_torch.pipeline import merge as tmerge
from kmdiff_tpu_torch.plugins import PluginError, load_model_plugin

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_PLUGINS = REPO / "examples" / "plugins"
PORT_PLUGINS = REPO / "kmdiff_tpu_torch" / "examples" / "plugins"
CPU = torch.device("cpu")

#: (JAX example, the port's twin)
PAIRS = {
    "numpy": ("fold_change_model.py", "fold_change_model.py"),
    "device": ("device_fold_change_model.py", "device_fold_change_model.py"),
}


def tmain(args):
    return torch_main(args, device="cpu")


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """The simulated cohort of test_torch_pipeline.py (20 kbp, 3 + 3, seed
    5), counted by the port at k = 31 and k = 63 into run31 / run63."""
    root = tmp_path_factory.mktemp("plugin_cohort")
    simulate(SimOptions(output_directory=str(root / "sim"), genome_len=20_000,
                        nb_controls=3, nb_cases=3, seed=5))
    for k in (31, 63):
        assert tmain(["count", "--file", str(root / "sim" / "fof.txt"),
                      "--run-dir", str(root / f"run{k}"), "--kmer-size",
                      str(k), "--nb-partitions", "4", "--threads", "2"]) == 0
    return root


@pytest.fixture(params=["fixture", "sim31", "sim63"])
def run_dir(request):
    """(run dir, nb controls, nb cases, k)."""
    if request.param == "fixture":
        return request.getfixturevalue("fixture_dir"), 1, 1, 20
    k = int(request.param[3:])
    return str(request.getfixturevalue("cohort") / f"run{k}"), 3, 3, k


def _outputs(out):
    out = pathlib.Path(out)
    files = {f"{g}_kmers.fasta": (out / f"{g}_kmers.fasta").read_bytes()
             for g in ("control", "case")}
    with open(out / "options.json") as f:
        files["total_kmers"] = json.load(f)["total_kmers"]
    return files


def _diff_both(run, nbc, nbk, pair, tmp_path, extra=(), jax_plugin=None,
               port_plugin=None):
    """diff --model with the JAX example through the JAX CLI and the port's
    twin through the port's CLI; returns both outputs (the FASTA files'
    bytes and the k-mers tested)."""
    jp, tp = PAIRS[pair] if pair else (None, None)
    base = ["diff", "--km-run-dir", str(run), "-1", str(nbc), "-2", str(nbk),
            "--threads", "2", *extra]
    assert jax_main([*base, "--model", str(jax_plugin or JAX_PLUGINS / jp),
                     "--output-dir", str(tmp_path / "j")]) == 0
    assert tmain([*base, "--model", str(port_plugin or PORT_PLUGINS / tp),
                  "--output-dir", str(tmp_path / "t")]) == 0
    return _outputs(tmp_path / "j"), _outputs(tmp_path / "t")


def _n_records(blob: bytes) -> int:
    return blob.count(b">")


# -- the host union merge -------------------------------------------------------

@pytest.mark.parametrize("nw,S,empty", [
    (1, 1, ()), (1, 5, (2,)), (2, 3, ()), (2, 4, (0, 3)), (4, 6, (5,)),
    (4, 2, (0, 1)), (1, 0, ()),
])
def test_merge_sorted_streams_matches_jax(nw, S, empty):
    rng = np.random.default_rng(nw * 10 + S)
    pool = rng.integers(0, 2**63, (3000, nw), dtype=np.uint64)
    pool[:50, 1:] = pool[0, 1:]  # rows that tie on every word but the first
    kmers_list, counts_list = [], []
    for s in range(S):
        n = 0 if s in empty else int(rng.integers(1, 2000))
        rows = np.unique(pool[rng.choice(len(pool), n, replace=False)], axis=0)
        kmers_list.append(rows)
        counts_list.append(rng.integers(1, 2**32, len(rows)).astype(np.uint32))
    got = tmerge.merge_sorted_streams(kmers_list, counts_list)
    want = jmerge.merge_sorted_streams(kmers_list, counts_list)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    if S and len(empty) < S:
        assert len(got[0]) > 0


# -- diff --model against the JAX package -----------------------------------------

@pytest.mark.parametrize("pair", ["numpy", "device"])
def test_diff_model_matches_jax(run_dir, pair, tmp_path):
    run, nbc, nbk, _k = run_dir
    args = ["-s", "0.5", "--cutoff", "1", "-c", "disabled", "--model-config",
            "1.5"]
    ref, ours = _diff_both(run, nbc, nbk, pair, tmp_path, args)
    assert ours == ref
    assert _n_records(ref["control_kmers.fasta"]) > 0
    assert _n_records(ref["case_kmers.fasta"]) > 0


def test_diff_model_defaults_match_jax(cohort, tmp_path):
    """The CLI's defaults (Bonferroni at 0.05, fold 2) with the device twin."""
    ref, ours = _diff_both(cohort / "run31", 3, 3, "device", tmp_path)
    assert ours == ref
    assert _n_records(ref["case_kmers.fasta"]) > 0


def test_main_diff_result_dicts_equal(cohort, tmp_path):
    """main_diff's result dicts (k-mers tested, control and case tallies)
    through both packages, with the device twin and the numpy one."""
    kw = dict(kmtricks_dir=str(cohort / "run63"), nb_controls=3, nb_cases=3,
              threshold=0.5, cutoff=1.0, nb_threads=2, model_config="1.5")
    for pair, (jp, tp) in PAIRS.items():
        ref = jax_main_diff(JaxDiffOptions(
            output_directory=str(tmp_path / f"j_{pair}"),
            correction=JaxCorrection.NOTHING,
            model_lib_path=str(JAX_PLUGINS / jp), **kw))
        ours = torch_main_diff(DiffOptions(
            output_directory=str(tmp_path / f"t_{pair}"),
            correction=CorrectionType.NOTHING,
            model_lib_path=str(PORT_PLUGINS / tp), **kw), CPU)
        assert ours == ref
        assert ours["control"] and ours["case"]


_SCALAR_PLUGIN = """
from {pkg}.core.model import IModel, Significance


class ScalarFold(IModel):
    def process(self, controls, cases):
        mc = float(sum(int(c) for c in controls)) / len(controls)
        mk = float(sum(int(c) for c in cases)) / len(cases)
        sig = (mk + 1.0) / (mc + 1.0) >= 1.5 or (mc + 1.0) / (mk + 1.0) >= 1.5
        sign = (Significance.CONTROL if mc > mk else
                Significance.CASE if mk > mc else Significance.NO)
        return (1e-9 if sig else 0.5), sign, mc, mk


def create_model(config):
    return ScalarFold()
"""


def _write_plugin(tmp_path, name, body, pkg):
    path = tmp_path / f"{name}_{pkg}.py"
    path.write_text(textwrap.dedent(body.format(pkg=pkg)))
    return path


def test_scalar_plugin_matches_jax(cohort, tmp_path):
    ref, ours = _diff_both(
        cohort / "run31", 3, 3, None, tmp_path,
        ["-s", "0.5", "--cutoff", "1", "-c", "disabled"],
        jax_plugin=_write_plugin(tmp_path, "scalar", _SCALAR_PLUGIN, "kmdiff_tpu"),
        port_plugin=_write_plugin(tmp_path, "scalar", _SCALAR_PLUGIN,
                                  "kmdiff_tpu_torch"))
    assert ours == ref
    assert _n_records(ref["case_kmers.fasta"]) > 0


@pytest.fixture(scope="module")
def matrix_run(cohort, tmp_path_factory):
    """cohort's k = 31 run dir with prebuilt count matrices (the JAX union
    merge of each partition)."""
    run = tmp_path_factory.mktemp("plugin_matrices") / "run"
    shutil.copytree(cohort / "run31", run)
    os.makedirs(run / "matrices")
    for p, paths in enumerate(jkm.get_partition_paths(str(run), 4)):
        streams = [jkm.read_kmer_file(x)[1:] for x in paths]
        kmers, counts = jmerge.merge_sorted_streams([s[0] for s in streams],
                                                    [s[1] for s in streams])
        jkm.write_matrix_file(str(run / "matrices" / f"matrix_{p}.count.lz4"),
                              kmers, counts, 31, p)
    return run


@pytest.mark.parametrize("pair", ["numpy", "device"])
def test_matrix_path_matches_jax(matrix_run, pair, tmp_path, monkeypatch):
    """Prebuilt matrices, streamed in blocks of 700 rows in both packages."""
    from kmdiff_tpu_torch.io import kmtricks as tkm

    monkeypatch.setattr(jkm, "MATRIX_STREAM_ROWS", 700)
    monkeypatch.setattr(tkm, "MATRIX_STREAM_ROWS", 700)
    ref, ours = _diff_both(matrix_run, 3, 3, pair, tmp_path,
                           ["-s", "0.5", "--cutoff", "1", "-c", "disabled",
                            "--model-config", "1.5"])
    assert ours == ref
    assert _n_records(ref["case_kmers.fasta"]) > 0


@pytest.mark.parametrize("pair,k", [("numpy", 31), ("device", 63)])
def test_save_sk_matrices_match_jax(cohort, pair, k, tmp_path):
    ref, ours = _diff_both(cohort / f"run{k}", 3, 3, pair, tmp_path,
                           ["-s", "0.5", "--cutoff", "1", "-c", "disabled",
                            "--save-sk", "--model-config", "1.5"])
    assert ours == ref
    mats = {}
    for side in ("j", "t"):
        d = tmp_path / side / "positive_kmer_matrix" / "matrices"
        mats[side] = {n: (d / n).read_bytes() for n in sorted(os.listdir(d))}
    assert len(mats["j"]) == 4 and mats["t"] == mats["j"]
    _info, kmers, counts = jkm.read_matrix_file(
        str(tmp_path / "t" / "positive_kmer_matrix" / "matrices" /
            "matrix_0.count.lz4"))
    assert len(kmers) > 0 and counts.shape[1] == 6


@pytest.mark.parametrize("rows", [1000, 4096])
def test_tiles_across_block_rows_match_jax(cohort, rows, tmp_path, monkeypatch):
    """The device twin over many tiles, the last one ragged (the JAX
    package pads it; the port passes it unpadded)."""
    monkeypatch.setattr(jmerge, "BLOCK_ROWS", rows)
    monkeypatch.setattr(tmerge, "BLOCK_ROWS", rows)
    tiles = []
    real = tmerge.PartitionProcessor._stage

    def spy(self, tile_rows):
        tiles.append(len(tile_rows))
        return real(self, tile_rows)

    monkeypatch.setattr(tmerge.PartitionProcessor, "_stage", spy)
    ref, ours = _diff_both(cohort / "run31", 3, 3, "device", tmp_path,
                           ["-s", "0.5", "--cutoff", "1", "-c", "disabled"])
    assert ours == ref
    assert max(tiles) == rows and any(0 < t < rows for t in tiles)
    assert len(tiles) > 4


# -- run --model, --pop-correction -------------------------------------------------

def test_run_model_matches_count_diff_and_jax(cohort, tmp_path):
    fof = str(cohort / "sim" / "fof.txt")
    tail = ["-1", "3", "-2", "3", "-s", "0.5", "--cutoff", "1", "-c",
            "disabled", "--threads", "2"]

    def run(main, plugin, tag):
        assert main(["run", "--file", fof, "-d", str(tmp_path / f"rd_{tag}"),
                     "-k", "31", "--nb-partitions", "4", *tail, "--model",
                     str(plugin), "-o", str(tmp_path / tag)]) == 0
        return _outputs(tmp_path / tag)

    ours = run(tmain, PORT_PLUGINS / "device_fold_change_model.py", "t")
    ref = run(jax_main, JAX_PLUGINS / "device_fold_change_model.py", "j")
    assert ours == ref
    # the standard flow: count files in the run dir, then the diff
    assert len(list((tmp_path / "rd_t" / "counts").rglob("*.kmer.lz4"))) == 24
    assert tmain(["diff", "--km-run-dir", str(cohort / "run31"), *tail,
                  "--model", str(PORT_PLUGINS / "device_fold_change_model.py"),
                  "--output-dir", str(tmp_path / "cd")]) == 0
    assert _outputs(tmp_path / "cd") == ours
    assert _n_records(ours["case_kmers.fasta"]) > 0


def test_model_drops_pop_correction(cohort, tmp_path, caplog, monkeypatch):
    base = ["diff", "--km-run-dir", str(cohort / "run31"), "-1", "3", "-2",
            "3", "-s", "0.5", "--cutoff", "1", "-c", "disabled", "--threads",
            "2", "--model", str(PORT_PLUGINS / "fold_change_model.py")]
    monkeypatch.setattr(logging.getLogger("kmdiff"), "propagate", True)
    with caplog.at_level(logging.WARNING, logger="kmdiff"):
        assert tmain([*base, "--pop-correction", "--kmer-pca", "0.05",
                      "--output-dir", str(tmp_path / "p")]) == 0
    assert any("population stratification correction disabled with custom "
               "models." in r.message for r in caplog.records)
    assert not (tmp_path / "p" / "popstrat").exists()
    assert tmain([*base, "--output-dir", str(tmp_path / "m")]) == 0
    assert _outputs(tmp_path / "p") == _outputs(tmp_path / "m")
    with open(tmp_path / "p" / "options.json") as f:
        assert json.load(f)["pop_correction"] is False


# -- the loader ---------------------------------------------------------------------

def test_loader_by_path_and_module_spec():
    by_path = load_model_plugin(str(PORT_PLUGINS / "fold_change_model.py"), "3")
    assert type(by_path).__name__ == "FoldChangeModel" and by_path.fold == 3.0
    mod = "kmdiff_tpu_torch.examples.plugins.device_fold_change_model"
    by_module = load_model_plugin(mod, "")
    assert by_module.fold == 2.0 and hasattr(by_module, "process_block_torch")
    by_factory = load_model_plugin(f"{mod}:create_model", "1.25")
    assert by_factory.fold == 1.25
    with pytest.raises(PluginError, match="does not expose a nope"):
        load_model_plugin(f"{mod}:nope")
    with pytest.raises(PluginError, match="cannot import model plugin"):
        load_model_plugin("kmdiff_tpu_torch.examples.plugins.no_such_model")


_JAX_ONLY_PLUGIN = """
from kmdiff_tpu_torch.core.model import IModel


class JaxOnly(IModel):
    def process_block_jax(self, counts, nb_controls):
        raise AssertionError("never called")


def create_model(config):
    return JaxOnly()
"""


def test_process_block_jax_only_model_refused(cohort, tmp_path):
    path = _write_plugin(tmp_path, "jaxonly", _JAX_ONLY_PLUGIN, "x")
    with pytest.raises(PluginError, match="process_block_torch"):
        load_model_plugin(str(path))
    out = tmp_path / "out"
    with pytest.raises(PluginError, match="process_block_jax"):
        tmain(["diff", "--km-run-dir", str(cohort / "run31"), "-1", "3", "-2",
               "3", "--model", str(path), "--output-dir", str(out)])
    assert not (out / "partitions").exists()  # refused before any merge


def test_processor_abi_choice():
    """The processor takes the first ABI a model has."""

    class Torch(IModel):
        def process_block_torch(self, counts, nb_controls):
            raise AssertionError

        def process_block(self, counts, nb_controls):
            raise AssertionError

    class Numpy(IModel):
        def process_block(self, counts, nb_controls):
            raise AssertionError

    class Scalar(IModel):
        def process(self, controls, cases):
            raise AssertionError

    for model, abi in ((Torch(), "torch"), (Numpy(), "numpy"), (Scalar(), "scalar")):
        assert tmerge.PartitionProcessor(model, 1, 1, 0.1, CPU).abi == abi


def test_device_twin_scores_wrapped_int32_counts():
    """A u32 count of 2^31 or more reaches process_block_torch as a negative
    int32 (the JAX ABI), and the scores equal the JAX device plugin's."""
    from kmdiff_tpu.plugins import load_model_plugin as jax_load

    counts = np.array([[1, 2, 3, 4], [2**31 + 5, 0, 7, 1], [0, 0, 0, 0],
                       [9, 9, 1, 1], [2**32 - 1, 3, 3, 3]], np.uint32)
    kmers = np.arange(len(counts), dtype=np.uint64)[:, None]
    got = []
    for load, plugins, proc_cls, kw in (
        (jax_load, JAX_PLUGINS, jmerge.PartitionProcessor, {}),
        (load_model_plugin, PORT_PLUGINS, tmerge.PartitionProcessor,
         {"device": CPU}),
    ):
        model = load(str(plugins / "device_fold_change_model.py"), "1.5")
        got.append(proc_cls(model, 2, 2, 1.0, **kw)._score_block(kmers, counts)[0])
    for field in ("kmers", "pvalues", "signs", "mean_control", "mean_case"):
        np.testing.assert_array_equal(getattr(got[1], field),
                                      getattr(got[0], field))
    assert got[1].mean_control[1] < 0  # the wrapped sum, as in the JAX ABI


def test_infos_on_the_cpu(capsys):
    assert tmain(["infos"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("kmdiff-tpu-torch ")
    assert f"torch      : {torch.__version__}" in out
    if not torch.cuda.is_available():
        assert "cuda: not available" in out
    for word in ("kernels    :", "native lib :", "process_block_torch",
                 "--distributed", "--devices N", "warmup", "--profile DIR",
                 "a mesh of N cards a rank", "KMDIFF_GROUP_MERGE"):
        assert word in out
    # port queue item 1 is the one thing not ported
    not_ported = out[out.index("not ported :"):]
    assert "item 1:" in not_ported
    for gone in ("item 7c", "item 10", "raises"):
        assert gone not in out


@pytest.mark.cuda
def test_device_twin_on_cuda_equals_cpu(cohort, tmp_path, monkeypatch):
    """The device twin through the processor on the card: its tiles are CUDA
    tensors, and the outputs equal the CPU run's byte for byte."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from kmdiff_tpu_torch.cmd import diff as tdiff
    from kmdiff_tpu_torch.examples.plugins import device_fold_change_model as dm

    devices = []

    class Spy(dm.DeviceFoldChangeModel):
        def process_block_torch(self, counts, nb_controls):
            devices.append(counts.device.type)
            return super().process_block_torch(counts, nb_controls)

    monkeypatch.setattr(tdiff, "load_custom_model", lambda _opt: Spy(1.5))
    outs = {}
    for where in ("cuda", "cpu"):
        opt = DiffOptions(kmtricks_dir=str(cohort / "run63"),
                          output_directory=str(tmp_path / where),
                          nb_controls=3, nb_cases=3, threshold=0.5,
                          cutoff=1.0, correction=CorrectionType.NOTHING,
                          nb_threads=4, model_lib_path="spy")
        res = tdiff.main_diff(opt, torch.device(where))
        outs[where] = (res, _outputs(tmp_path / where))
    assert outs["cuda"] == outs["cpu"]
    assert outs["cpu"][0]["case"] > 0
    assert set(devices) == {"cuda", "cpu"}


@pytest.mark.cuda
def test_device_twin_threads_share_no_staging(monkeypatch):
    """Sixteen threads score their own count matrices through one processor
    on the card, in tiles of 1,000 rows, with a short switch interval: every
    row's scores equal the CPU processor's, so no tile read another
    thread's staged rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import concurrent.futures as cf
    import sys

    monkeypatch.setattr(tmerge, "BLOCK_ROWS", 1000)
    model = load_model_plugin(str(PORT_PLUGINS / "device_fold_change_model.py"))
    gpu = tmerge.PartitionProcessor(model, 5, 5, 0.5, torch.device("cuda", 0))
    cpu = tmerge.PartitionProcessor(model, 5, 5, 0.5, CPU)
    rng = np.random.default_rng(13)
    blocks = [rng.integers(0, 40, (int(rng.integers(20_000, 60_000)), 10)
                           ).astype(np.uint32) for _ in range(16)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with cf.ThreadPoolExecutor(16) as pool:
            futs = [pool.submit(gpu._plugin_scores, b) for b in blocks]
            got = [f.result(timeout=300) for f in futs]
    finally:
        sys.setswitchinterval(old)
    for b, scores in zip(blocks, got):
        for g, w in zip(scores, cpu._plugin_scores(b)):
            np.testing.assert_array_equal(g, w)
