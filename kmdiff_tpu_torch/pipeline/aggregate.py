"""Final aggregation: drain accumulators, apply multiple-testing correction,
write control/case outputs.

Reference: include/kmdiff/aggregator.hpp:26-365 — a thread-pool drain feeding
two writer threads through bounded blocking queues, with two variants:
streaming `aggregator` (order-free correctors) and `sorted_aggregator`
(Benjamini/Holm: global spinlocked priority queue walked in ascending-p order
with stop-at-first-rejection).

Re-design: correction over columnar p-value arrays. The order-free path is a
vectorized mask per block; the order-dependent path is one global argsort +
prefix-AND (ops.correct) — no heap, no locks, deterministic
output order (partition-major, k-mer ascending; the reference's streaming
variant is scheduling-order-dependent, ours is reproducible).

Routing parity (aggregator.hpp:151-163, 293-303): CONTROL-signed k-mers go
to control_kmers.{fasta|kff}; everything else (CASE and NO) to
case_kmers.{fasta|kff}. FASTA ranks restart per file and follow write order.
"""

from __future__ import annotations

import os

import numpy as np

from kmdiff_tpu_torch.core.corrector import ICorrector
from kmdiff_tpu_torch.core.kmer import packed_to_strings
from kmdiff_tpu_torch.core.model import Significance
from kmdiff_tpu_torch.io.accumulator import IAccumulator, KmerSignBlock
from kmdiff_tpu_torch.io.fasta import FastaWriter, format_header
from kmdiff_tpu_torch.io.kff import KffWriter
from kmdiff_tpu_torch.ops.correct import correction_mask_sorted


class _OutputPair:
    """The two routed writers (control / case)."""

    def __init__(self, output_dir: str, kmer_size: int, kff: bool):
        ext = "kff" if kff else "fasta"
        self.kff = kff
        self.kmer_size = kmer_size
        cpath = os.path.join(output_dir, f"control_kmers.{ext}")
        kpath = os.path.join(output_dir, f"case_kmers.{ext}")
        if kff:
            self.control = KffWriter(cpath, kmer_size)
            self.case = KffWriter(kpath, kmer_size)
        else:
            self.control = FastaWriter(cpath)
            self.case = FastaWriter(kpath)
        self.control_count = 0
        self.case_count = 0

    def write_block(self, block: KmerSignBlock) -> None:
        seqs = packed_to_strings(block.kmers, self.kmer_size)
        is_control = block.signs == int(Significance.CONTROL)
        for i, seq in enumerate(seqs):
            if is_control[i]:
                w, rank = self.control, self.control_count
                self.control_count += 1
            else:
                w, rank = self.case, self.case_count
                self.case_count += 1
            if self.kff:
                w.write_kmer(seq)
            else:
                w.write(
                    format_header(
                        rank, block.pvalues[i], block.mean_control[i], block.mean_case[i]
                    ),
                    seq,
                )

    def close(self):
        self.control.close()
        self.case.close()


class Aggregator:
    """Single entry point replacing both reference aggregator variants."""

    def __init__(
        self,
        accumulators: list[IAccumulator],
        corrector: ICorrector,
        kmer_size: int,
        output_dir: str,
        kff: bool = False,
        threshold: float = 0.0,
        total_kmers: int = 0,
        progress=None,
    ):
        self.accs = accumulators
        self.corrector = corrector
        self.kmer_size = kmer_size
        self.output_dir = output_dir
        self.kff = kff
        self.threshold = threshold
        self.total = total_kmers
        self.progress = progress
        self.control_count = 0
        self.case_count = 0

    def counts(self) -> tuple[int, int]:
        return self.control_count, self.case_count

    def run(self) -> None:
        out = _OutputPair(self.output_dir, self.kmer_size, self.kff)
        try:
            if self.corrector.order_dependent:
                self._run_sorted(out)
            else:
                self._run_streaming(out)
        finally:
            out.close()
        self.control_count = out.control_count
        self.case_count = out.case_count

    # -- order-free correctors: vectorized mask per block ---------------------

    def _run_streaming(self, out: _OutputPair) -> None:
        ctype = self.corrector.type()
        for acc in self.accs:
            for block in acc.blocks():
                # stateless predicates: the sorted-mask helper applied to an
                # unsorted array is the plain elementwise rule
                keep = correction_mask_sorted(
                    block.pvalues, ctype, self.threshold, self.total
                )
                if keep.any():
                    out.write_block(block.take(np.nonzero(keep)[0]))
            if self.progress is not None:
                self.progress.tick()

    # -- order-dependent correctors: global sort + prefix walk ----------------

    #: in-memory row budget for the order-dependent path. The reference
    #: holds EVERY hit in a RAM priority queue and only warns about it
    #: (src/cli.cpp:226-243, aggregator.hpp:240-322); above this budget we
    #: spill stable-sorted runs to disk and stream a heap merge instead.
    SORT_BUDGET_ROWS = 1 << 23

    def _run_sorted(self, out: _OutputPair) -> None:
        # env override (read per run) lets the dryrun/stress harness force
        # the spill-and-merge path on tiny cohorts
        budget = int(
            os.environ.get("KMDIFF_AGG_SORT_ROWS", self.SORT_BUDGET_ROWS)
        )
        runs: list[str] = []
        pending: list[KmerSignBlock] = []
        pending_rows = 0
        try:
            for acc in self.accs:
                for block in acc.blocks():
                    if len(block) == 0:
                        continue
                    pending.append(block)
                    pending_rows += len(block)
                    if pending_rows >= budget:
                        runs.append(self._spill_run(pending))
                        pending, pending_rows = [], 0
                if self.progress is not None:
                    self.progress.tick()
            if not runs:
                self._sorted_in_memory(pending, out)
                return
            if pending:
                runs.append(self._spill_run(pending))
            self._merge_runs(runs, out)
        finally:
            for path in runs:
                try:
                    os.remove(path)
                except OSError:
                    pass

    def _sorted_in_memory(self, blocks: list[KmerSignBlock], out) -> None:
        if not blocks:
            return
        allb = KmerSignBlock.concat(blocks)
        order = np.argsort(allb.pvalues, kind="stable")
        mask = correction_mask_sorted(
            allb.pvalues[order], self.corrector.type(), self.threshold, self.total
        )
        survivors = order[mask]
        if len(survivors):
            out.write_block(allb.take(survivors))

    # external sort machinery -------------------------------------------------

    def _run_dtype(self, nw: int) -> np.dtype:
        return np.dtype([
            ("p", "<f8"),
            ("kmer", "<u8", (nw,)),
            ("sign", "i1"),
            ("mc", "<f8"),
            ("mk", "<f8"),
        ])

    def _spill_run(self, blocks: list[KmerSignBlock]) -> str:
        """Stable-sort a batch by ascending p and spill it as one run.
        Count rows are dropped — aggregation never writes them."""
        import tempfile

        allb = KmerSignBlock.concat(blocks)
        order = np.argsort(allb.pvalues, kind="stable")
        rec = np.empty(len(allb), dtype=self._run_dtype(allb.kmers.shape[1]))
        rec["p"] = allb.pvalues[order]
        rec["kmer"] = allb.kmers[order]
        rec["sign"] = allb.signs[order]
        rec["mc"] = allb.mean_control[order]
        rec["mk"] = allb.mean_case[order]
        fd, path = tempfile.mkstemp(
            prefix="agg_run_", suffix=".bin", dir=self.output_dir
        )
        with os.fdopen(fd, "wb") as f:
            rec.tofile(f)
        return path

    def _merge_runs(self, runs: list[str], out: _OutputPair) -> None:
        """Heap-merge the sorted runs in ascending (p, run-order) — the
        exact tie-break of a global stable sort over the same stream —
        and walk the corrector with stop-at-first-rejection semantics
        (aggregator.hpp:286-310)."""
        import heapq

        nw = None
        cursors = []
        CHUNK = 1 << 16
        for ri, path in enumerate(runs):
            f = open(path, "rb")
            cursors.append({"file": f, "buf": None, "pos": 0, "idx": ri})
        try:
            nw = (self.kmer_size + 31) // 32
            dt = self._run_dtype(nw)

            def refill(cur):
                cur["buf"] = np.fromfile(cur["file"], count=CHUNK, dtype=dt)
                cur["pos"] = 0
                return len(cur["buf"]) > 0

            heap = []
            for cur in cursors:
                if refill(cur):
                    heapq.heappush(
                        heap, (cur["buf"]["p"][0], cur["idx"], cur)
                    )

            rank = 0
            batch: list[np.ndarray] = []
            ctype = self.corrector.type()
            stop = False
            while heap and not stop:
                _p, _ri, cur = heapq.heappop(heap)
                row = cur["buf"][cur["pos"]]
                if self._passes(float(row["p"]), rank, ctype):
                    rank += 1
                    batch.append(row)
                    if len(batch) >= CHUNK:
                        self._write_rows(np.array(batch, dtype=dt), out, nw)
                        batch = []
                else:
                    stop = True
                    break
                cur["pos"] += 1
                if cur["pos"] >= len(cur["buf"]):
                    if not refill(cur):
                        cur["file"].close()
                        cur["file"] = None
                        continue
                heapq.heappush(
                    heap, (cur["buf"]["p"][cur["pos"]], cur["idx"], cur)
                )
            if batch:
                self._write_rows(np.array(batch, dtype=dt), out, nw)
        finally:
            for cur in cursors:
                if cur["file"] is not None:
                    cur["file"].close()

    def _passes(self, p: float, rank: int, ctype) -> bool:
        """Scalar walk predicate — the SAME boundary definition as the
        vectorized mask (ops.correct.threshold_at_rank is the single
        source; reference: src/corrector.cpp:9-89)."""
        from kmdiff_tpu_torch.ops.correct import threshold_at_rank

        return p < float(threshold_at_rank(ctype, self.threshold, self.total, rank))

    def _write_rows(self, rows: np.ndarray, out: _OutputPair, nw: int) -> None:
        block = KmerSignBlock(
            np.ascontiguousarray(rows["kmer"]).reshape(len(rows), nw),
            np.ascontiguousarray(rows["p"]),
            np.ascontiguousarray(rows["sign"]),
            np.ascontiguousarray(rows["mc"]),
            np.ascontiguousarray(rows["mk"]),
            None,
        )
        out.write_block(block)

