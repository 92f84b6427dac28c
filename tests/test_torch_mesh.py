"""The port's mesh runtime (kmdiff_tpu_torch/parallel/: mesh, runtime,
count_step, merge_step, diff_step) on N CPU shards, against the JAX
package on its eight virtual CPU devices (tests/conftest.py) and against
the port's own one-shard runs. Inputs come from numpy seeds; integers and
output files must be equal, and the f32 LR within the filter's margin
(MARGIN_PER_COUNT * (s_c + s_k) + MARGIN_ABS, kmdiff_tpu/ops/lrt.py:45-46).

- make_sharded_diff_step against the JAX step (R = 512, S = 8, seed 0);
- count_regroup against make_sharded_count_regroup;
- count_sample_device_mesh at k = 21, 40 and 63 against the JAX mesh count
  and the port's one-device count, also in rounds (a small SORT_ROWS);
- K-PART's twin (partition_targets_plain) against host_partition_ids mod D
  and JAX's partition_ids_lanes for nw = 1-4 with sentinel rows;
- GlobalMerge with configure(1) and configure(8): identical blocks, also
  with chunked partitions and on the prebuilt-matrix path;
- the CLI with --devices 2 and 8 against --devices 1 and the JAX CLI's
  --devices 8: count + diff, the fused run, popstrat diff --save-sk and
  count at k = 63;
- the sharded Gram and alt fits against the unsharded ones;
- the runtime: --devices 0 on the CPU, KMDIFF_DEVICES, virtual meshes,
  --devices 2 beside a --distributed coordinator that opens no group (the
  mesh in one process), and a CUDA mesh larger than the machine (it
  raises).

Two tests need the card (the cuda marker) and skip without one: K-PART
against its twin at the mesh count's shapes, and every kernel of the mesh
paths launched on cuda:1 when a second card exists.
"""

import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmdiff_tpu.cli import main as jax_main
from kmdiff_tpu.ops.codec import partition_ids_lanes
from kmdiff_tpu.ops.lrt import LrtParams as JaxLrtParams
from kmdiff_tpu.parallel import make_mesh as jax_make_mesh
from kmdiff_tpu.parallel import make_sharded_diff_step as jax_diff_step
from kmdiff_tpu.parallel.count_step import (
    make_sharded_count_regroup,
    shard_triples,
)
from kmdiff_tpu.parallel.diff_step import shard_rows
from kmdiff_tpu.pipeline import count as jcount
from kmdiff_tpu.pipeline.simulate import SimOptions, simulate
from kmdiff_tpu_torch import kernels
from kmdiff_tpu_torch.cli import main as torch_main
from kmdiff_tpu_torch.ops import codec, pca
from kmdiff_tpu_torch.ops.lrt import MARGIN_ABS, MARGIN_PER_COUNT
from kmdiff_tpu_torch.parallel import runtime
from kmdiff_tpu_torch.parallel.count_step import count_regroup
from kmdiff_tpu_torch.parallel.diff_step import make_sharded_diff_step
from kmdiff_tpu_torch.parallel.mesh import Mesh, make_mesh
from kmdiff_tpu_torch.pipeline import count as tcount
from kmdiff_tpu_torch.pipeline import fused as tfused
from kmdiff_tpu_torch.pipeline import merge as tmerge

CPU = torch.device("cpu")
#: the command lines' shard counts held against one shard and JAX's eight
SHARDS = (2, 8)


@pytest.fixture(autouse=True)
def _reset_port_runtime():
    """Library calls below configure the port's mesh runtime; forget it
    after every test."""
    yield
    runtime.configure(None)
    runtime.set_virtual(False)


def _files(root):
    out = {}
    for d, _sub, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _same_tree(a, b):
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb)
    for name in fa:
        assert fa[name] == fb[name], name
    return fa


# -- the kernels' twins and the steps ------------------------------------------


def test_sharded_diff_step_matches_jax():
    nb_controls, nb_cases = 3, 5
    R, S = 8 * 64, nb_controls + nb_cases
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 50, size=(R, S), dtype=np.int32)
    params = JaxLrtParams(nb_controls, nb_cases, 100_000, 120_000, 0.01)
    args = (np.float32(params.ratio_c), np.float32(params.ratio_k),
            np.float32(params.lr_min))
    jmesh = jax_make_mesh(8)
    want = jax_diff_step(jmesh, nb_controls)(
        shard_rows(jmesh, jnp.asarray(counts)), *(jnp.float32(a) for a in args))
    keep_j, lr_j, sc_j, sk_j, stats_j = (np.asarray(x) for x in want)
    keep, lr, s_c, s_k, stats = make_sharded_diff_step(
        make_mesh(8, CPU), nb_controls)(counts, *args)
    np.testing.assert_array_equal(keep, keep_j)
    np.testing.assert_array_equal(s_c, sc_j)
    np.testing.assert_array_equal(s_k, sk_j)
    np.testing.assert_array_equal(stats, stats_j)
    margin = MARGIN_PER_COUNT * (s_c + s_k) + MARGIN_ABS
    assert np.all(np.abs(lr - lr_j) <= margin)
    assert stats[0] == R and stats[1] == keep.sum() == stats[2] + stats[3]
    # keep alone, as the matrix path asks for it
    keep2, lr2, s_c2, _s_k2, stats2 = make_sharded_diff_step(
        make_mesh(3, CPU), nb_controls)(counts.view(np.uint32), *args,
                                        want_lr=False)
    assert lr2 is None
    np.testing.assert_array_equal(keep2, keep)
    np.testing.assert_array_equal(s_c2, s_c)
    np.testing.assert_array_equal(stats2, stats)


def test_count_regroup_matches_jax():
    D, nb_partitions, L = 8, 16, 256
    N = D * L
    rng = np.random.default_rng(0)
    hi = rng.integers(0, 2**31, N, dtype=np.uint32)
    lo = rng.integers(0, 2**32, N, dtype=np.uint32)
    sample = rng.integers(0, 4, N, dtype=np.int32)
    count = rng.integers(1, 9, N, dtype=np.int32)
    # a few repeated (k-mer, sample) rows, so the count orders ties
    hi[1::97], lo[1::97], sample[1::97] = hi[0], lo[0], sample[0]
    pad = rng.random(N) < 0.05
    hi[pad] = lo[pad] = 0xFFFFFFFF
    count[pad] = 0
    jmesh = jax_make_mesh(8)
    step = make_sharded_count_regroup(jmesh, nb_partitions, bucket_cap=128)
    r_hi, r_lo, r_sm, r_c, dropped = (np.asarray(x) for x in step(
        *shard_triples(jmesh, hi, lo, sample, count)))
    assert int(dropped[0]) == 0

    words = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    keys = torch.from_numpy(codec.words_to_keys(words[:, None]))
    got = count_regroup(
        make_mesh(D, CPU), [keys[d * L:(d + 1) * L] for d in range(D)],
        [torch.from_numpy(sample[d * L:(d + 1) * L]) for d in range(D)],
        [torch.from_numpy(count[d * L:(d + 1) * L]) for d in range(D)],
        nb_partitions)
    per_dev = len(r_hi) // D
    total = 0
    for d, (k, sm, c) in enumerate(got):
        seg = slice(d * per_dev, (d + 1) * per_dev)
        real = ~((r_hi[seg] == 0xFFFFFFFF) & (r_lo[seg] == 0xFFFFFFFF))
        w = codec.keys_to_words(k.numpy())[:, 0]
        np.testing.assert_array_equal(w >> np.uint64(32), r_hi[seg][real])
        np.testing.assert_array_equal(w & np.uint64(0xFFFFFFFF), r_lo[seg][real])
        np.testing.assert_array_equal(sm.numpy(), r_sm[seg][real])
        np.testing.assert_array_equal(c.numpy(), r_c[seg][real])
        total += len(c)
    assert total == int((~pad).sum())


def _reads_codes(seed, n_reads=30, read_len=250):
    rng = np.random.default_rng(seed)
    reads = ["".join(rng.choice(list("ACGT"), read_len)) for _ in range(n_reads)]
    return jcount._flat_codes([s.encode() for s in reads * 2])


@pytest.mark.parametrize("k", [21, 40, 63])
def test_count_sample_device_mesh_matches_jax(k, monkeypatch):
    codes = _reads_codes(5)
    want = jcount.count_sample_device_mesh([codes], k, 7, jax_make_mesh(8))
    one = tcount.count_sample_device([codes], k, 7, CPU)
    for D in (2, 8):
        got = tcount.count_sample_device_mesh([codes], k, 7, make_mesh(D, CPU))
        for g, w, o in zip(got, want, one):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, o)
    # in rounds: a sample above D x SORT_ROWS windows, each shard merging its
    # rounds on the host
    monkeypatch.setattr(tcount, "SORT_ROWS", 1000)
    got = tcount.count_sample_device_mesh([codes[:7000], codes[7000:]], k, 7,
                                          make_mesh(3, CPU))
    for g, o in zip(got, tcount.count_sample_device([codes[:7000], codes[7000:]],
                                                    k, 7, CPU)):
        np.testing.assert_array_equal(g, o)


@pytest.mark.parametrize("nw", [1, 2, 3, 4])
def test_partition_targets_plain_matches_jax(nw):
    rng = np.random.default_rng(nw)
    n, P = 5000, 13
    words = rng.integers(0, 2**63, (n, nw), dtype=np.uint64) * np.uint64(2) \
        + rng.integers(0, 2, (n, nw)).astype(np.uint64)
    words[::97] = np.uint64(0xFFFFFFFFFFFFFFFF)  # sentinel rows
    lanes = []
    for w in range(nw):
        lanes += [(words[:, w] >> np.uint64(32)).astype(np.uint32),
                  (words[:, w] & np.uint64(0xFFFFFFFF)).astype(np.uint32)]
    jparts = np.asarray(partition_ids_lanes(tuple(jnp.asarray(x) for x in lanes), P))
    hparts = tcount.host_partition_ids(words, P)
    np.testing.assert_array_equal(jparts, hparts)
    keys = torch.from_numpy(codec.words_to_keys(words))
    for D in (1, 2, 4, 7):
        targets, counts = codec.partition_targets_plain(keys, P, D)
        want = (hparts % D).astype(np.int32)
        want[::97] = D
        assert targets.dtype == torch.int32 and counts.dtype == torch.int64
        np.testing.assert_array_equal(targets.numpy(), want)
        np.testing.assert_array_equal(counts.numpy(),
                                      np.bincount(want, minlength=D + 1))
        # the wrapper takes the twin for a CPU tensor
        t2, c2 = codec.partition_targets(keys, P, D)
        assert torch.equal(t2, targets) and torch.equal(c2, counts)
    with pytest.raises(ValueError, match="shards"):
        codec.partition_targets(keys, P, 0)


def test_sharded_int_gram_matches_unsharded():
    rng = np.random.default_rng(3)
    for B, S in ((1, 5), (7, 20), (1000, 20), (4099, 33)):
        X = (rng.random((B, S)) < 0.3).astype(np.uint8)
        want = pca._int_gram(X, Mesh((CPU,)))
        Xf = X.astype(np.float64)
        np.testing.assert_array_equal(want, Xf.T @ Xf)
        for D in (2, 3, 8):
            np.testing.assert_array_equal(
                pca._int_gram(X, make_mesh(D, CPU)), want)


# -- the runtime -----------------------------------------------------------------


def test_runtime_resolution(monkeypatch):
    monkeypatch.delenv("KMDIFF_DEVICES", raising=False)
    assert runtime.get_mesh(CPU) == Mesh((CPU,))  # never configured
    runtime.configure(0)
    assert runtime.get_mesh(CPU) == Mesh((CPU,))  # 0 = one shard on the CPU
    runtime.configure(1)
    assert runtime.get_mesh(CPU) == Mesh((CPU,))
    runtime.configure(3)
    mesh = runtime.get_mesh(CPU)
    assert mesh == Mesh((CPU,) * 3) and mesh.distinct() == [CPU]
    assert runtime.get_mesh(CPU) is mesh  # built once a configuration
    runtime.configure(None)
    monkeypatch.setenv("KMDIFF_DEVICES", "4")
    assert runtime.get_mesh(CPU).size == 4
    # a virtual CUDA mesh repeats the device; distinct cards must exist
    cuda0 = torch.device("cuda", 0)
    assert make_mesh(2, cuda0, virtual=True).devices == (cuda0, cuda0)
    assert make_mesh(2, cuda0, virtual=True).distinct() == [cuda0]
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"need {have + 1} CUDA devices"):
        make_mesh(have + 1, cuda0)
    runtime.configure(have + 2)
    with pytest.raises(ValueError, match="CUDA devices"):
        runtime.get_mesh(cuda0)
    runtime.set_virtual(True)
    assert runtime.get_mesh(cuda0).devices == (cuda0,) * (have + 2)


def test_mesh_map_order_and_errors():
    mesh = make_mesh(4, CPU)
    assert mesh.map(lambda d, dev: (d, dev)) == [(d, CPU) for d in range(4)]
    assert mesh.map(lambda d, dev: d, 2) == [0, 1]
    assert mesh.blocks(0) == [(0, 0)]
    assert mesh.blocks(3) == [(0, 1), (1, 2), (2, 3)]
    assert mesh.blocks(10) == [(0, 2), (2, 5), (5, 7), (7, 10)]

    def boom(d, dev):
        if d == 2:
            raise RuntimeError("shard 2")
        return d

    with pytest.raises(RuntimeError, match="shard 2"):
        mesh.map(boom)


# -- the pipeline ------------------------------------------------------------------


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_cohort")
    simulate(SimOptions(output_directory=str(root / "sim"), genome_len=20_000,
                        nb_controls=3, nb_cases=3, seed=5))
    return root


LOOSE = ["-1", "3", "-2", "3", "-s", "0.5", "--cutoff", "1", "-c", "disabled",
         "--threads", "2"]


def _commands(root, tag, fof):
    """The CLI commands held across shard counts, their outputs under
    root/<command>_<tag>."""
    count = ["--file", fof, "--nb-partitions", "4", "--threads", "2"]
    run_dir = str(root / f"count_{tag}")
    return {
        "count": ["count", *count, "-k", "31", "--run-dir", run_dir],
        "diff": ["diff", "--km-run-dir", run_dir, *LOOSE, "--output-dir",
                 str(root / f"diff_{tag}")],
        "popstrat": ["diff", "--km-run-dir", run_dir, *LOOSE,
                     "--pop-correction", "--kmer-pca", "0.05", "--save-sk",
                     "--output-dir", str(root / f"popstrat_{tag}")],
        "run": ["run", *count, "-k", "31", *LOOSE, "--run-dir",
                str(root / f"runrd_{tag}"), "--output-dir",
                str(root / f"run_{tag}")],
        "count63": ["count", *count, "-k", "63", "--run-dir",
                    str(root / f"count63_{tag}")],
    }


@pytest.fixture(scope="module")
def cli_runs(cohort):
    """Every command through the port's CLI at 1, 2 and 8 shards, and
    through the JAX CLI at --devices 8 (its virtual mesh)."""
    fof = str(cohort / "sim" / "fof.txt")
    for D in (1, *SHARDS):
        for argv in _commands(cohort, f"t{D}", fof).values():
            assert torch_main([*argv, "--devices", str(D)], device="cpu") == 0
    for argv in _commands(cohort, "j8", fof).values():
        assert jax_main([*argv, "--devices", "8"]) == 0
    return cohort


FASTA = ("control_kmers.fasta", "case_kmers.fasta")


@pytest.mark.parametrize("D", SHARDS)
@pytest.mark.parametrize("command", ["count", "diff", "popstrat", "run",
                                     "count63"])
def test_cli_mesh_matches_one_shard_and_jax(cli_runs, command, D):
    root = cli_runs
    out = {"count": "count", "diff": "diff", "popstrat": "popstrat",
           "run": "run", "count63": "count63"}[command]
    ours, one, jax_ = (root / f"{out}_{tag}" for tag in (f"t{D}", "t1", "j8"))
    files = _same_tree(ours, one)
    if command.startswith("count"):
        assert sum(n.endswith(".kmer.lz4") for n in files) == 4 * 6
        _same_tree(ours, jax_)
    elif command == "popstrat":
        names = [*FASTA, "popstrat/pcs.evec", "popstrat/gwas_eigenstratX.geno",
                 *(f"positive_kmer_matrix/matrices/matrix_{p}.count.lz4"
                   for p in range(4))]
        jfiles = _files(jax_)
        for name in names:
            assert files[name] == jfiles[name], name
    else:
        jfiles = _files(jax_)
        for name in (*FASTA, "options.json"):
            assert files[name] == jfiles[name], name
    if command in ("diff", "run"):
        assert files["case_kmers.fasta"] and files["control_kmers.fasta"]
    if command == "run":
        # the fused run's FASTA is the loose diff's
        diff = _files(root / f"diff_t{D}")
        assert all(files[n] == diff[n] for n in FASTA)
        _same_tree(root / f"runrd_t{D}" / "counts", root / f"count_t{D}" / "counts")


def test_global_merge_mesh_matches_one_shard(cli_runs, monkeypatch):
    """GlobalMerge over a run directory with configure(1) and configure(8):
    the same k-mers tested and identical blocks, with partitions merged
    whole and in key-range chunks (a small MAX_DEVICE_ROWS), with count
    rows (keep_counts) and without."""
    from kmdiff_tpu_torch.core.model import PoissonLikelihood
    from kmdiff_tpu_torch.io.accumulator import KmerSignBlock, VectorAccumulator
    from kmdiff_tpu_torch.io.kmtricks import (
        get_partition_paths,
        get_total_kmer,
        read_config,
    )

    run_dir = str(cli_runs / "count_t1")
    config = read_config(run_dir)
    tc, tk = get_total_kmer(run_dir, 3, 3, config.abundance_min)

    def merge(keep_counts):
        proc = tmerge.PartitionProcessor(PoissonLikelihood(3, 3, tc, tk), 3, 3,
                                         0.5, CPU, keep_counts=keep_counts)
        accs = [VectorAccumulator() for _ in range(config.nb_partitions)]
        merger = tmerge.GlobalMerge(proc, accs, nb_threads=2)
        total = merger.merge_partitions(
            get_partition_paths(run_dir, config.nb_partitions))
        return merger, [KmerSignBlock.concat(list(a.blocks())) for a in accs], total

    for keep_counts in (False, True):
        runtime.configure(1)
        m1, b1, t1 = merge(keep_counts)
        for rows in (tmerge.MAX_DEVICE_ROWS, 3000):
            monkeypatch.setattr(tmerge, "MAX_DEVICE_ROWS", rows)
            runtime.configure(8)
            m8, b8, t8 = merge(keep_counts)
            assert t1 == t8 > 0
            assert m1.nb_sign() == m8.nb_sign() > 0
            assert m1.signs() == m8.signs()
            for x, y in zip(b1, b8):
                np.testing.assert_array_equal(x.kmers, y.kmers)
                np.testing.assert_array_equal(x.pvalues, y.pvalues)
                np.testing.assert_array_equal(x.signs, y.signs)
                if keep_counts:
                    np.testing.assert_array_equal(x.counts_ratio, y.counts_ratio)


def test_global_merge_mesh_on_the_reference_fixture(fixture_dir):
    """The JAX package's test on the reference's kmtricks fixture
    (tests/test_parallel.py:131-175): 320 k-mers, identical blocks."""
    from kmdiff_tpu_torch.core.model import PoissonLikelihood
    from kmdiff_tpu_torch.io.accumulator import KmerSignBlock, VectorAccumulator
    from kmdiff_tpu_torch.io.kmtricks import (
        get_partition_paths,
        get_total_kmer,
        read_config,
    )

    config = read_config(fixture_dir)
    tc, tk = get_total_kmer(fixture_dir, 1, 1, config.abundance_min)

    def run():
        proc = tmerge.PartitionProcessor(PoissonLikelihood(1, 1, tc, tk), 1, 1,
                                         0.5, CPU, keep_counts=True)
        accs = [VectorAccumulator() for _ in range(config.nb_partitions)]
        merger = tmerge.GlobalMerge(proc, accs, nb_threads=2)
        total = merger.merge_partitions(
            get_partition_paths(fixture_dir, config.nb_partitions))
        return merger, accs, total

    runtime.configure(1)
    m1, a1, t1 = run()
    runtime.configure(8)
    m8, a8, t8 = run()
    assert t1 == t8 == 320
    assert m1.signs() == m8.signs()
    for p in range(config.nb_partitions):
        b1 = KmerSignBlock.concat(list(a1[p].blocks()))
        b8 = KmerSignBlock.concat(list(a8[p].blocks()))
        np.testing.assert_array_equal(b1.kmers, b8.kmers)
        np.testing.assert_array_equal(b1.pvalues, b8.pvalues)
        np.testing.assert_array_equal(b1.counts_ratio, b8.counts_ratio)


def test_fused_run_mesh_many_chunks(cli_runs, tmp_path, monkeypatch):
    """The fused run with a small chunk budget on 3 shards (several
    dispatches of three chunks, the last one short), plain and with
    popstrat: byte-identical to the one-shard outputs."""
    monkeypatch.setattr(tfused, "FUSED_CHUNK_ROWS", 5000)
    fof = str(cli_runs / "sim" / "fof.txt")
    for extra, ref in (([], "diff_t1"),
                       (["--pop-correction", "--kmer-pca", "0.05"], None)):
        outs = []
        for D in (1, 3):
            out = tmp_path / f"out{D}{len(extra)}"
            assert torch_main(["run", "--file", fof, "-k", "31",
                               "--nb-partitions", "4", *LOOSE, *extra,
                               "--run-dir", str(tmp_path / f"rd{D}{len(extra)}"),
                               "--output-dir", str(out), "--devices", str(D)],
                              device="cpu") == 0
            outs.append(_files(out))
        for name in FASTA:
            assert outs[0][name] == outs[1][name], name
            if ref:
                assert outs[0][name] == (cli_runs / ref / name).read_bytes()
        if extra:
            assert outs[0]["popstrat/pcs.evec"] == outs[1]["popstrat/pcs.evec"]


def test_matrix_path_mesh_matches_one_shard(cli_runs, tmp_path):
    """diff on prebuilt count matrices: D tiles at once through the sharded
    diff step (K-LRT on each shard), byte-identical output."""
    import shutil

    from kmdiff_tpu_torch.io.kmtricks import (
        get_partition_paths,
        read_kmer_file,
        write_matrix_file,
    )

    run_dir = tmp_path / "mrun"
    shutil.copytree(cli_runs / "count_t1", run_dir)
    os.makedirs(run_dir / "matrices")
    for p, paths in enumerate(get_partition_paths(str(run_dir), 4)):
        streams = [read_kmer_file(x)[1:] for x in paths]
        kmers, counts = tmerge.merge_sorted_streams([s[0] for s in streams],
                                                    [s[1] for s in streams])
        write_matrix_file(str(run_dir / "matrices" / f"matrix_{p}.count.lz4"),
                          kmers, counts, 31, p)
    outs = []
    for D in (1, 4):
        out = tmp_path / f"m{D}"
        assert torch_main(["diff", "--km-run-dir", str(run_dir), *LOOSE,
                           "--output-dir", str(out), "--devices", str(D)],
                          device="cpu") == 0
        outs.append(_files(out))
    for name in FASTA:
        assert outs[0][name] == outs[1][name] != b""


def test_popstrat_alt_fits_split_over_shards():
    """The alt fits' item ranges over a mesh's shards: each shard's part is
    its range's own fit, bit for bit, concatenated in shard order. (The
    CPU twin's batched f32 products round by batch size, so the split is
    held within f32 rounding of the whole block's fit; K-IRLS fits an item
    alone, which chip_smoke.py phase 2 checks, and CPU shards fit the
    block whole in correct_block.)"""
    from kmdiff_tpu_torch.pipeline.popstrat import PopStratCorrector

    rng = np.random.default_rng(2)
    corr = PopStratCorrector(3, 3, [1000] * 3, [1100] * 3, 2, device=CPU)
    corr.set_Z(rng.normal(size=(6, 3)))
    corr.init_global_features()
    Xb = np.column_stack([corr.alt_features[:, :-1], np.zeros(6)])
    ratios = rng.normal(size=(301, 6))
    whole = corr._alt_loglik(Xb, ratios, Mesh((CPU,)))
    mesh = make_mesh(4, CPU)
    assert mesh.blocks(301) == [(0, 75), (75, 150), (150, 225), (225, 301)]
    got = corr._alt_loglik(Xb, ratios, mesh)
    np.testing.assert_array_equal(got, np.concatenate([
        corr._alt_loglik(Xb, ratios[a:b], Mesh((CPU,)))
        for a, b in mesh.blocks(301)]))
    # the repo's K-IRLS-against-twin tolerance for ll (other summation
    # orders, both f32; tests/test_torch_kernels_cuda.py)
    np.testing.assert_allclose(got, whole, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(
        corr._alt_loglik(Xb, ratios[:2], make_mesh(4, CPU)),
        np.concatenate([corr._alt_loglik(Xb, ratios[i:i + 1], Mesh((CPU,)))
                        for i in (0, 1)]))


# -- the errors --------------------------------------------------------------------


@pytest.mark.parametrize("extra", [
    ["--distributed", "127.0.0.1:1", "--num-processes", "1", "--process-id", "0"],
    ["--distributed", "127.0.0.1:1"],
])
def test_devices_beside_distributed_without_a_group_run_the_mesh(
        cli_runs, tmp_path, extra):
    """--devices 2 beside --distributed (the mesh under the multi-process
    runtime): a coordinator with one process, or none, opens no group, and
    the command runs the two-shard mesh in this process; its run directory
    is the one-shard count's. (Two ranks of two shards:
    tests/test_torch_mesh_distributed.py.)"""
    from kmdiff_tpu_torch.parallel import distributed

    fof = str(cli_runs / "sim" / "fof.txt")
    argv = _commands(tmp_path, "g", fof)["count"]
    assert torch_main([*argv, "--devices", "2", *extra], device="cpu") == 0
    assert not distributed.is_distributed()
    _same_tree(tmp_path / "count_g", cli_runs / "count_t1")


def test_devices_with_coordinator_env_without_a_group_run_the_mesh(
        cli_runs, tmp_path, monkeypatch):
    monkeypatch.setenv("KMDIFF_COORDINATOR", "127.0.0.1:1")
    monkeypatch.delenv("KMDIFF_NUM_PROCESSES", raising=False)
    fof = str(cli_runs / "sim" / "fof.txt")
    argv = _commands(tmp_path, "e", fof)["count"]
    assert torch_main([*argv, "--devices", "2"], device="cpu") == 0
    _same_tree(tmp_path / "count_e", cli_runs / "count_t1")


def test_cuda_mesh_larger_than_the_machine_raises(cohort, tmp_path):
    """--devices N on CUDA with fewer cards raises before anything runs,
    neither on the CPU nor on fewer shards (here: no card at all, or all
    the cards there are plus one)."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            torch_main(["count", "--file", str(cohort / "sim" / "fof.txt"),
                        "--run-dir", str(tmp_path / "rd"), "--devices", "2"],
                       device="cuda")
        runtime.configure(2)
        with pytest.raises(ValueError, match="need 2 CUDA devices"):
            runtime.get_mesh(torch.device("cuda", 0))
        return
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=f"need {n} CUDA devices"):
        torch_main(["count", "--file", str(cohort / "sim" / "fof.txt"),
                    "--run-dir", str(tmp_path / "rd"), "--devices", str(n)],
                   device="cuda")
    assert not any((tmp_path / "rd" / "counts").rglob("*.kmer.lz4"))


# -- on the card -------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    kernels.lib()
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_partition_targets_kernel_matches_twin(dev):
    """K-PART on the card: 2^20 one-word and 2^19 two- to four-word keys
    (a view of a wider buffer), sentinel rows, D from 1 to 1024, 0 rows."""
    rng = np.random.default_rng(11)
    for nw, n in ((1, 1 << 20), (2, 1 << 19), (3, 1 << 19), (4, 1 << 19), (1, 0),
                  (1, 1), (2, 257)):
        words = rng.integers(0, 2**63, (n, nw), dtype=np.uint64) * np.uint64(2)
        words[::31] = np.uint64(0xFFFFFFFFFFFFFFFF)
        keys = torch.from_numpy(codec.words_to_keys(words)).to(dev)
        if nw > 1:
            wide = torch.zeros((nw, n + 5), dtype=torch.int64, device=dev)
            wide[:, :n] = keys
            keys = wide[:, :n]
        for P, D in ((4, 2), (4, 4), (7, 3), (1, 1), (4096, 1024)):
            before = kernels.launch_counts()["partition_ids"]
            t, c = codec.partition_targets(keys, P, D)
            assert kernels.launch_counts()["partition_ids"] == before + 1
            tp, cp = codec.partition_targets_plain(keys.cpu(), P, D)
            assert torch.equal(t.cpu(), tp) and torch.equal(c.cpu(), cp)


@pytest.mark.cuda
def test_mesh_kernels_launch_on_a_second_card(dev, tmp_path, cohort):
    """Every kernel of the mesh paths, launched on cuda:1 by a two-card
    mesh: count (k = 31 and 63), diff, popstrat diff and the fused run,
    their outputs equal to one card's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second NVIDIA GPU")
    fof = str(cohort / "sim" / "fof.txt")
    for D in (1, 2):
        kernels.reset_launch_counts()
        for argv in _commands(tmp_path, f"c{D}", fof).values():
            assert torch_main([*argv, "--devices", str(D)], device=dev) == 0
        by_device = kernels.launch_counts_by_device()
    for name in ("canonical_kmers", "canonical_kmers_mw", "partition_ids",
                 "run_bounds", "run_bounds_mw", "compact", "lrt_filter",
                 "assemble_chunk", "run_rows", "geno_sample", "int_gram", "irls"):
        assert by_device.get(1, {}).get(name, 0) > 0, name
    for out in ("count", "diff", "popstrat", "run", "count63"):
        _same_tree(tmp_path / f"{out}_c2", tmp_path / f"{out}_c1")


def test_port_sources_of_the_mesh_exist():
    root = pathlib.Path(__file__).resolve().parents[1] / "kmdiff_tpu_torch"
    for name in ("mesh", "runtime", "count_step", "merge_step", "diff_step"):
        assert (root / "parallel" / f"{name}.py").exists(), name
    assert (root / "csrc" / "partition_ids.cu").exists()
    assert "partition_ids" in kernels.KERNELS
    assert jax.device_count() == 8
