"""The port's `call` (k-mers -> reference loci), its host k-mer codec and
its KFF reader against the JAX package's, on the same seeded inputs: the
TSV files byte-identical, every array equal, no tolerance."""

import numpy as np
import pytest

from kmdiff_tpu.cli import main as jax_main
from kmdiff_tpu.core import kmer as jkmer
from kmdiff_tpu.io import kff as jkff
from kmdiff_tpu.pipeline.call import CallOptions as JaxCallOptions
from kmdiff_tpu.pipeline.call import main_call as jax_main_call
from kmdiff_tpu_torch.cli import main as torch_main
from kmdiff_tpu_torch.core import kmer as tkmer
from kmdiff_tpu_torch.io import kff as tkff
from kmdiff_tpu_torch.pipeline.call import CallOptions, main_call

K_VALUES = [8, 31, 32, 33, 63, 128]


def _revcomp(s):
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


@pytest.mark.parametrize("k", K_VALUES)
def test_host_kmer_codec_matches_jax(k):
    rng = np.random.default_rng(k)
    seq = "".join(rng.choice(list("ACGTacgtN"), 3 * k + 400,
                             p=[0.24] * 4 + [0.01] * 4 + [0.0]))
    seq = seq[:50] + "N" + seq[51:200] + "n" + seq[201:]
    got = tkmer.seq_to_codes(seq)
    want = jkmer.seq_to_codes(seq)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert tkmer.seq_to_codes(seq.encode())[0].tobytes() == want[0].tobytes()
    packed = tkmer.kmers_from_codes(*got, k)
    np.testing.assert_array_equal(packed, jkmer.kmers_from_codes(*want, k))
    windows = np.lib.stride_tricks.sliding_window_view(got[1], k).all(axis=1)
    assert packed.shape == (int(windows.sum()), tkmer.n_words(k))
    np.testing.assert_array_equal(tkmer.revcomp_packed(packed, k),
                                  jkmer.revcomp_packed(packed, k))
    canon = tkmer.canonical_packed(packed, k)
    np.testing.assert_array_equal(canon, jkmer.canonical_packed(packed, k))
    strings = tkmer.packed_to_strings(packed, k)
    rc = tkmer.packed_to_strings(tkmer.revcomp_packed(packed, k), k)
    assert rc[0] == _revcomp(strings[0].upper())
    one = strings[3]
    np.testing.assert_array_equal(tkmer.string_to_packed(one),
                                  jkmer.string_to_packed(one))
    with pytest.raises(ValueError, match="invalid base"):
        tkmer.string_to_packed(one[:-1] + "N")
    order_payload = np.arange(len(packed))
    got_sorted = tkmer.sort_packed(canon, order_payload)
    want_sorted = jkmer.sort_packed(canon, order_payload)
    for g, w in zip(got_sorted, want_sorted):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k", [8, 31, 63, 128])
def test_kff_reader_reads_both_packages_files(k, tmp_path):
    rng = np.random.default_rng(k + 1)
    seqs = ["".join(rng.choice(list("ACGT"), k)) for _ in range(57)]
    for writer_mod in (jkff, tkff):
        path = tmp_path / f"{writer_mod.__name__}.kff"
        with writer_mod.KffWriter(str(path), k) as w:
            for s in seqs:
                w.write_kmer(s)
        for reader_mod in (jkff, tkff):
            with reader_mod.KffReader(str(path)) as r:
                assert list(r.kmers()) == seqs
                assert r.vars == {"k": k, "max": 1, "data_size": 0}
                assert r.encoding == (0, 1, 3, 2)
    assert tkff.pack_2bit_strings(seqs) == jkff.pack_2bit_strings(seqs)
    for s in seqs[:5]:
        assert tkff.unpack_2bit(tkff.pack_2bit(s), k) == s
    bad = tmp_path / "bad.kff"
    bad.write_bytes(b"NOPE")
    with pytest.raises(tkff.FormatError, match="not a KFF file"):
        tkff.KffReader(str(bad))


def _genome(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


@pytest.fixture(params=[31, 63])
def call_inputs(request, tmp_path):
    """A three-contig reference with repeats (a motif four times, once
    reverse-complemented), an N run and a lowercase stretch; queries: forward
    and reverse-complement hits, the motif, misses; as FASTA and as KFF."""
    k = request.param
    rng = np.random.default_rng(k)
    motif = _genome(rng, k)
    c1 = _genome(rng, 900) + motif + _genome(rng, 300) + motif + _genome(rng, 50)
    c2 = (_genome(rng, 200) + "N" * 40 + _revcomp(motif) + _genome(rng, 700)
          + motif)
    c3 = _genome(rng, 400).lower() + _genome(rng, 30)
    (tmp_path / "ref.fasta").write_text(
        f">chr1 first contig\n{c1[:500]}\n{c1[500:]}\n>chr2\n{c2}\n>chr3\n{c3}\n")
    queries = [c1[10:10 + k], _revcomp(c1[300:300 + k]), motif,
               _revcomp(motif), c2[500:500 + k], c3[100:100 + k].upper(),
               "A" * k, _genome(rng, k), c1[10:10 + k]]
    with open(tmp_path / "q.fasta", "w") as f:
        for i, q in enumerate(queries):
            f.write(f">q{i}_pval=0.01\n{q}\n")
    with tkff.KffWriter(str(tmp_path / "q.kff"), k) as w:
        for q in queries:
            w.write_kmer(q)
    return tmp_path, k


@pytest.mark.parametrize("fmt", ["fasta", "kff"])
@pytest.mark.parametrize("k_hint", [False, True])
def test_call_matches_jax(call_inputs, fmt, k_hint, tmp_path):
    root, k = call_inputs
    kw = dict(kmer_file=str(root / f"q.{fmt}"), reference=str(root / "ref.fasta"),
              kmer_size=k if k_hint else 0)
    want = jax_main_call(JaxCallOptions(output=str(tmp_path / "j.tsv"), **kw))
    got = main_call(CallOptions(output=str(tmp_path / "t.tsv"), **kw))
    assert got == want
    assert got["mapped"] == 7 and got["hits"] > got["mapped"]
    assert (tmp_path / "t.tsv").read_bytes() == (tmp_path / "j.tsv").read_bytes()


def test_call_cli_matches_jax(call_inputs, tmp_path):
    root, k = call_inputs
    args = ["call", "-i", str(root / "q.fasta"), "-r", str(root / "ref.fasta")]
    assert jax_main([*args, "-o", str(tmp_path / "j.tsv")]) == 0
    assert torch_main([*args, "-o", str(tmp_path / "t.tsv")], device="cpu") == 0
    assert (tmp_path / "t.tsv").read_bytes() == (tmp_path / "j.tsv").read_bytes()
    rows = (tmp_path / "t.tsv").read_text().splitlines()
    assert rows[0] == "kmer_id\tkmer\tcontig\tpos\tstrand" and len(rows) > 8


def test_call_empty_and_invalid_queries(tmp_path):
    (tmp_path / "ref.fasta").write_text(">c\nACGTACGTACGTAC\n")
    (tmp_path / "none.fasta").write_text("")
    res = main_call(CallOptions(kmer_file=str(tmp_path / "none.fasta"),
                                reference=str(tmp_path / "ref.fasta"),
                                output=str(tmp_path / "e.tsv")))
    assert res == {"queries": 0, "mapped": 0, "hits": 0}
    assert (tmp_path / "e.tsv").read_bytes() == b""
    (tmp_path / "bad.fasta").write_text(">a\nACGTACGT\n>b\nACGTNCGT\n")
    for call, opts in ((main_call, CallOptions), (jax_main_call, JaxCallOptions)):
        with pytest.raises(ValueError, match="not a valid 8-mer"):
            call(opts(kmer_file=str(tmp_path / "bad.fasta"),
                      reference=str(tmp_path / "ref.fasta"),
                      output=str(tmp_path / "x.tsv")))
