"""The port's own copies of the JAX package's host modules against the
originals: the command-line parser (every subcommand and option), the
kmtricks count, matrix and histogram files, the LZ4 spills and frames of
io.lz4 and the native library, and popstrat's Eigenstrat writers and k-mer
sampler. Bytes and masks must be identical, and each package must read the
other's files.
"""

import argparse
import io
import logging

import numpy as np
import pytest

from kmdiff_tpu import cli as jcli
from kmdiff_tpu import native as jnative
from kmdiff_tpu.io import accumulator as jacc
from kmdiff_tpu.io import kmtricks as jkm
from kmdiff_tpu.io import lz4 as jlz4
from kmdiff_tpu.io.kmtricks import Fof
from kmdiff_tpu.pipeline import popstrat as jpop
from kmdiff_tpu_torch import cli as tcli
from kmdiff_tpu_torch import native as tnative
from kmdiff_tpu_torch.io import accumulator as tacc
from kmdiff_tpu_torch.io import kmtricks as tkm
from kmdiff_tpu_torch.io import lz4 as tlz4
from kmdiff_tpu_torch.pipeline import popstrat as tpop


def _subparsers(parser):
    (action,) = [a for a in parser._actions
                 if isinstance(a, argparse._SubParsersAction)]
    return action.choices


def _options(sub):
    return {tuple(sorted(a.option_strings)) or (a.dest,): a for a in sub._actions
            if not isinstance(a, argparse._HelpAction)}


def _type_probe(t):
    """What a type converter does with a few strings (range checkers are
    closures, so they compare by behaviour)."""
    if t is None:
        return None
    out = []
    for s in ("0", "1", "2", "0.001", "0.3", "8", "31", "200"):
        try:
            out.append(t(s))
        except (argparse.ArgumentTypeError, ValueError):
            out.append("refused")
    return out


SUBCOMMANDS = sorted(_subparsers(jcli.build_parser()))


def test_parser_has_the_same_subcommands():
    assert sorted(_subparsers(tcli.build_parser())) == SUBCOMMANDS
    assert len(SUBCOMMANDS) >= 7


@pytest.mark.parametrize("command", SUBCOMMANDS)
def test_parser_options_match_jax(command):
    want = _options(_subparsers(jcli.build_parser())[command])
    got = _options(_subparsers(tcli.build_parser())[command])
    assert sorted(got) == sorted(want)
    for key, a in want.items():
        b = got[key]
        for field in ("dest", "default", "choices", "nargs", "required", "const"):
            assert getattr(b, field) == getattr(a, field), (command, key, field)
        assert type(b) is type(a), (command, key)
        assert _type_probe(b.type) == _type_probe(a.type), (command, key)


def test_a_command_line_parses_alike():
    argv = ["run", "--file", "fof.txt", "-d", "rd", "-k", "21", "-1", "3",
            "-2", "4", "-s", "0.01", "--pop-correction", "--kmer-pca", "0.02",
            "--n-pc", "3", "--save-sk", "-c", "holm", "--threads", "2"]
    assert vars(tcli.build_parser().parse_args(argv)) == vars(
        jcli.build_parser().parse_args(argv))


def _kmers_counts(rng, n, nw, top):
    kmers = np.sort(rng.integers(0, 2**63, (n, nw), dtype=np.uint64), axis=0)
    return kmers, rng.integers(1, top, n).astype(np.uint32)


@pytest.mark.parametrize("k,count_bytes,top", [(21, 1, 200), (31, 2, 60_000),
                                               (31, 4, 2**32 - 1), (45, 4, 9)])
def test_count_files_byte_identical_and_cross_read(tmp_path, k, count_bytes, top):
    rng = np.random.default_rng(k + count_bytes)
    kmers, counts = _kmers_counts(rng, 5000, (k + 31) // 32, top)
    paths = {}
    for name, mod in (("j", jkm), ("t", tkm)):
        paths[name] = str(tmp_path / f"{name}.kmer.lz4")
        mod.write_kmer_file(paths[name], kmers, counts, k, sample_idx=3,
                            partition=2, count_bytes=count_bytes)
    with open(paths["j"], "rb") as a, open(paths["t"], "rb") as b:
        assert a.read() == b.read()
    for reader, path in ((tkm, paths["j"]), (jkm, paths["t"])):
        info, km, ct = reader.read_kmer_file(path)
        assert (info.kmer_size, info.sample_idx, info.partition) == (k, 3, 2)
        np.testing.assert_array_equal(km, kmers)
        np.testing.assert_array_equal(ct, counts)


def test_matrix_files_byte_identical_and_streamed_by_both(tmp_path):
    rng = np.random.default_rng(5)
    kmers, _ = _kmers_counts(rng, 3000, 1, 2)
    counts = rng.integers(0, 500, (3000, 6)).astype(np.uint32)
    for name, mod in (("j", jkm), ("t", tkm)):
        mod.write_matrix_file(str(tmp_path / f"{name}.count.lz4"), kmers, counts,
                              31, 1)
    assert ((tmp_path / "j.count.lz4").read_bytes()
            == (tmp_path / "t.count.lz4").read_bytes())
    for reader, name in ((tkm, "j"), (jkm, "t")):
        info, blocks = reader.open_matrix_stream(str(tmp_path / f"{name}.count.lz4"),
                                                 rows_per_block=700)
        parts = list(blocks)
        assert info.count_slots == 6 and len(parts) == 5
        np.testing.assert_array_equal(np.concatenate([p[0] for p in parts]), kmers)
        np.testing.assert_array_equal(np.concatenate([p[1] for p in parts]), counts)


def test_hist_files_byte_identical_and_cross_read(tmp_path):
    rng = np.random.default_rng(9)
    counts = np.minimum(rng.geometric(0.3, 20_000), 400).astype(np.uint32)
    for name, mod in (("j", jkm), ("t", tkm)):
        mod.write_hist(str(tmp_path / f"{name}.hist"),
                       mod.hist_from_counts(counts, 4, 31))
    assert (tmp_path / "j.hist").read_bytes() == (tmp_path / "t.hist").read_bytes()
    uvec = np.bincount(np.minimum(counts, 256), minlength=257)
    dev = tkm.hist_from_device(uvec, int(counts.sum()), len(counts), 4, 31)
    tkm.write_hist(str(tmp_path / "d.hist"), dev)
    assert (tmp_path / "d.hist").read_bytes() == (tmp_path / "j.hist").read_bytes()
    for reader, name in ((tkm, "j"), (jkm, "t")):
        h = reader.read_hist(str(tmp_path / f"{name}.hist"))
        assert (h.idx, h.kmer_size, h.unique) == (4, 31, len(counts))


def _spill_blocks(rng, S):
    blocks = []
    for n in (700, 1, 2500):
        blocks.append(jacc.KmerSignBlock(
            np.sort(rng.integers(0, 2**62, (n, 1), dtype=np.uint64), axis=0),
            rng.random(n), rng.integers(0, 3, n).astype(np.int8),
            rng.random(n) * 40, rng.random(n) * 40,
            rng.random((n, S)) if S else None))
    return blocks


@pytest.mark.parametrize("nb_samples", [0, 5])
def test_spills_byte_identical_and_cross_read(tmp_path, nb_samples):
    blocks = _spill_blocks(np.random.default_rng(nb_samples), nb_samples)
    for name, mod in (("j", jacc), ("t", tacc)):
        acc = mod.FileAccumulator(str(tmp_path / f"p0_{name}"), 31, read=False,
                                  delete_on_destroy=False, nb_samples=nb_samples)
        for b in blocks:
            acc.push_block(mod.KmerSignBlock(b.kmers, b.pvalues, b.signs,
                                             b.mean_control, b.mean_case,
                                             b.counts_ratio))
        acc.finish()
    assert (tmp_path / "p0_j").read_bytes() == (tmp_path / "p0_t").read_bytes()
    want = jacc.KmerSignBlock.concat(blocks)
    for mod, name in ((tacc, "j"), (jacc, "t")):
        got = mod.KmerSignBlock.concat(list(mod.FileAccumulator(
            str(tmp_path / f"p0_{name}"), 31, read=True,
            nb_samples=nb_samples).blocks()))
        for f in ("kmers", "pvalues", "signs", "mean_control", "mean_case",
                  "counts_ratio"):
            a, b = getattr(got, f), getattr(want, f)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["fast", "store"])
@pytest.mark.parametrize("size", [0, 1000, 300_000])
def test_native_frames_byte_identical(mode, size):
    data = np.random.default_rng(size).integers(0, 7, size).astype(np.uint8)
    assert tnative.available()
    assert tnative.library_path().startswith(tnative.BUILD_DIR)
    ours = tnative.lz4_frame_compress(data, mode=mode).tobytes()
    assert ours == jnative.lz4_frame_compress(data, mode=mode).tobytes()
    assert tnative.lz4_frame_decompress(ours).tobytes() == data.tobytes()
    # the pure-Python codecs of both packages read the native frames
    assert tlz4.Lz4FrameReader(io.BytesIO(ours)).read_all() == data.tobytes()
    assert jlz4.Lz4FrameReader(io.BytesIO(ours)).read_all() == data.tobytes()


def test_python_fallback_without_the_native_library(tmp_path, monkeypatch, caplog):
    """Without a toolchain the port warns once and writes and reads its files
    through the pure-Python codec and numpy; the JAX package reads them."""
    monkeypatch.setattr(tnative, "_tried", False)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "library_path",
                        lambda: str(tmp_path / "none" / "lib.so"))
    monkeypatch.setattr(tnative, "_build", lambda out: (_ for _ in ()).throw(
        FileNotFoundError("no make")))
    logger = logging.getLogger("kmdiff")
    monkeypatch.setattr(logger, "propagate", True)
    with caplog.at_level(logging.WARNING, logger="kmdiff"):
        assert not tnative.available()
        assert not tnative.available()
    warned = [r for r in caplog.records if "native host-IO library" in r.message]
    assert len(warned) == 1 and warned[0].levelno == logging.WARNING
    rng = np.random.default_rng(3)
    kmers, counts = _kmers_counts(rng, 2000, 1, 300)
    path = str(tmp_path / "t.kmer.lz4")
    tkm.write_kmer_file(path, kmers, counts, 31, sample_idx=0, partition=0,
                        count_bytes=2)
    _info, km, ct = jkm.read_kmer_file(path)
    np.testing.assert_array_equal(km, kmers)
    np.testing.assert_array_equal(ct, counts)
    jkm.write_kmer_file(str(tmp_path / "j.kmer.lz4"), kmers, counts, 31,
                        sample_idx=0, partition=0, count_bytes=2)
    _info, km, ct = tkm.read_kmer_file(str(tmp_path / "j.kmer.lz4"))
    np.testing.assert_array_equal(km, kmers)
    np.testing.assert_array_equal(ct, counts)


def test_popstrat_writers_byte_identical(tmp_path):
    rng = np.random.default_rng(4)
    fof = Fof.parse(_fof_file(tmp_path, 7))
    gender = {"s0": "M", "s2": "F", "s5": "U"}
    Z = rng.normal(0, 0.3, (7, 10))
    for name, mod in (("j", jpop), ("t", tpop)):
        d = tmp_path / name
        d.mkdir()
        mod.write_parfile(str(d / "parfile.txt"))
        mod.write_gwas_info(fof, str(d / "gwas_eigenstratX.ind"), 3, gender)
        mod.write_totals(str(d / "gwas_eigenstratX.total"), [10, 20, 30],
                         [40, 50, 60, 70])
        mod.write_pcs_evec(str(d / "pcs.evec"), Z)
    for f in ("parfile.txt", "gwas_eigenstratX.ind", "control.ind", "case.ind",
              "gwas_eigenstratX.total", "pcs.evec"):
        assert (tmp_path / "j" / f).read_bytes() == (tmp_path / "t" / f).read_bytes(), f


def _fof_file(tmp_path, n):
    path = tmp_path / "fof.txt"
    path.write_text("".join(f"s{i} : r{i}.fa\n" for i in range(n)))
    return str(path)


@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.001, 0), (0.05, 7), (1.0, 3)])
def test_sample_mask_matches_jax(rate, seed):
    rng = np.random.default_rng(seed)
    for nw in (1, 2):
        kmers = rng.integers(0, 2**64 - 1, (50_000, nw), dtype=np.uint64)
        np.testing.assert_array_equal(tpop.sample_mask(kmers, rate, seed),
                                      jpop.sample_mask(kmers, rate, seed))
