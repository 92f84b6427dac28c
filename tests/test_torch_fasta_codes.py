"""The fused run's decode of FASTA/FASTQ files on the device
(kmdiff_tpu_torch/io/fasta.py::device_codes, K-FASTA's plain twin
ops.codec.fasta_codes_plain on the CPU) against the port's host parser
flat_codes and the JAX package's, on the CPU.

Each case is a file: single-line and multi-line FASTA, lower case, N and
IUPAC letters, \\r\\n line ends, no final newline, empty lines, '>' inside
a sequence line, a strict FASTQ and a malformed one (which the record parser
takes), .gz, an empty file, and seeded random FASTA and FASTQ files whose
sizes straddle K-FASTA's 8192-byte tiles (the same sizes run through the
kernel in tests/test_torch_kernels_cuda.py). The codes must be equal byte
for byte, through one staging buffer that has just held a larger file, and
a collecting command's tallies (profiling.collect) must count the file, and
count it as the record parser's exactly where flat_codes takes that parser.
A file that starts with neither '>' nor '@' is refused by all three.
"""

import gzip

import numpy as np
import pytest
import torch

from kmdiff_tpu.io.fasta import flat_codes as jax_flat_codes
from kmdiff_tpu_torch import profiling
from kmdiff_tpu_torch.io import fasta
from kmdiff_tpu_torch.ops import codec

CPU = torch.device("cpu")
#: K-FASTA's tile (csrc/fasta_codes.cu)
TILE = 8192


def random_file(size: int, seed: int, fastq: bool) -> bytes:
    """`size` bytes of a random FASTA (headers, sequence lines of 0-300
    bytes, letters, N, IUPAC, '\\r', '>' inside lines) or strict FASTQ
    (cut at `size`, so most are not strict), from `seed`."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGTACGTacgtNnRY\r>", dtype=np.uint8)
    out = bytearray()
    while len(out) < size:
        name = b"r%d" % len(out)
        if fastq:
            n = int(rng.integers(1, 200))
            seq = bytes(letters[rng.integers(0, 16, n)])
            out += b"@" + name + b"\n" + seq + b"\n+\n" + b"I" * n + b"\n"
        else:
            out += b">" + name + b"\n"
            for _ in range(int(rng.integers(1, 4))):
                n = int(rng.choice([0, 1, 60, 151, 300]))
                out += bytes(letters[rng.integers(0, len(letters), n)]) + b"\n"
    return bytes(out[:size])


CASES = {
    "single_line": b">r1\nACGTACGTTGCA\n>r2\nGGGCCCAAATTT\n",
    "multi_line": b">r1 two lines\nACGTAC\nGTTGCA\nTT\n>r2\nGGGCCC\nAAA\n",
    "lower_n_iupac": b">r1\nacgtNNacgtRYKMSWBDHVnacgt\n>r2\nACGTuUacgt\n",
    "crlf": b">r1\r\nACGTACGT\r\nGGCC\r\n>r2\r\nTTTTAAAA\r\n",
    "no_final_newline": b">r1\nACGTACGT\n>r2\nGGCCAATT",
    "empty_lines": b">r1\n\nACGT\n\n\nGGCC\n>r2\n\n>r3\nTTAA\n\n",
    "gt_inside_line": b">r1\nACGT>ACGT\nAC>\n>r2\nGG>CC\n",
    "header_only": b">only a header",
    "fastq_strict": b"@r1\nACGTNACGT\n+\nIIIIIIIII\n@r2 x\nggcc\n+r2 x\n!!!!\n",
    "fastq_no_final_newline": b"@r1\nACGT\n+\nIIII\n@r2\nGGCC\n+\nIIII",
    "fastq_malformed": b"@r1\nACGT\nACGT\n+\nIIII\nIIII\n@r2\nGGCC\n+\n!!!!\n",
    "fastq_bad_plus": b"@r1\nACGT\n-\nIIII\n",
    "empty": b"",
    "long_line": b">assembly\n" + b"ACGTTGCAN" * 5000 + b"\n>r2\nAC\n",
    "gz": b">r1\nACGTACGT\nTTGG\n>r2\nCCAA\n",
    "gz_fastq": b"@r1\nACGT\n+\nIIII\n",
    "gz_random_fasta": random_file(3 * TILE + 1, 7, False),
    "not_fasta": b"ACGT\n>r1\nACGT\n",
    **{f"random_fasta_{n}": random_file(n, n, False)
       for n in (1, 15, 16, 17, TILE - 1, TILE, TILE + 1, 2 * TILE + 5,
                 3 * TILE - 1, 40_003)},
    **{f"random_fastq_{n}": random_file(n, n, True)
       for n in (TILE - 1, TILE + 1, 3 * TILE + 9)},
}


def strict_fastq(data: bytes) -> bool:
    """flat_codes' test of a FASTQ file, on its lines: a multiple of four,
    lines 0 mod 4 starting with '@', lines 2 mod 4 with '+'."""
    lines = data.split(b"\n")[:-1] if data.endswith(b"\n") else data.split(b"\n")
    return (len(lines) % 4 == 0 and all(x[:1] == b"@" for x in lines[0::4])
            and all(x[:1] == b"+" for x in lines[2::4]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_codes_equal_flat_codes(tmp_path, case):
    data = CASES[case]
    fastq = data[:1] == b"@"
    path = tmp_path / (f"{case}.fq" if fastq else f"{case}.fa")
    if case.startswith("gz"):
        path = path.with_name(path.name + ".gz")
        with gzip.open(path, "wb") as f:
            f.write(data)
    else:
        path.write_bytes(data)
    larger = tmp_path / "larger.fa"
    larger.write_bytes(b">x\n" + b"T" * (len(data) + 1000) + b"\n")
    timings: dict = {}
    with fasta.FileStaging(CPU) as staging, profiling.collect(timings):
        fasta.device_codes(str(larger), CPU, staging)
        if case == "not_fasta":
            for parse in (fasta.flat_codes, jax_flat_codes,
                          lambda p: fasta.device_codes(p, CPU, staging)):
                with pytest.raises(ValueError, match="not FASTA/FASTQ"):
                    parse(str(path))
            return
        got = fasta.device_codes(str(path), CPU, staging)
    want = fasta.flat_codes(str(path))
    np.testing.assert_array_equal(want, jax_flat_codes(str(path)))
    assert got.dtype == torch.uint8 and got.device == CPU
    np.testing.assert_array_equal(got.numpy(), want)
    # the record parser takes exactly the FASTQ files that are not strict
    strict = not fastq or strict_fastq(data)
    assert timings["parse_files"] == 2
    assert timings["parse_fallback_files"] == (0 if strict else 1)
    if case in ("fastq_malformed", "fastq_bad_plus"):
        assert not strict
    if data:
        codes, ok = codec.fasta_codes_plain(
            torch.frombuffer(bytearray(data), dtype=torch.uint8), fastq)
        assert ok == strict
        if strict:
            np.testing.assert_array_equal(codes.numpy(), want)
