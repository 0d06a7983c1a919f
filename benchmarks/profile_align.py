"""Phase profile of align_pair_batch on the 60 Mb rehearsal dataset.

Times each phase of the pair-alignment engine (seeding/lookup/cluster,
job build, device score, pairing, device extend, traceback+NM, column
emission, FASTQ decode) to locate the stage-level bottleneck the
VERDICT round-5 item 1 names.

Usage: python benchmarks/profile_align.py [n_batches]
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np

WORK = Path("/tmp/wgs60")
BATCH = 4096


def main():
    n_batches = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    from falcon_genome_tpu.aligner import (
        AlignerEngine, AlignerParams, MinimizerIndex, alignments_to_columns,
        find_candidates_batch)
    from falcon_genome_tpu.io.fastq import FastqReader
    from falcon_genome_tpu.io import native_ext

    from falcon_genome_tpu.stages.common import load_index
    t0 = time.perf_counter()
    idx = load_index(str(WORK / "ref.fa"))
    print(f"index load: {time.perf_counter()-t0:.1f}s "
          f"({len(idx.hashes)/1e6:.0f}M entries)")
    eng = AlignerEngine(idx, AlignerParams())

    T = {}

    def tick(name, t):
        T[name] = T.get(name, 0.0) + t

    reader = FastqReader(str(WORK / "r_1.fastq"), str(WORK / "r_2.fastq"),
                         batch_size=BATCH)
    it = iter(reader)

    # warm the kernels
    b1, b2 = next(it)
    eng.align_pair_batch(b1.codes, b1.lengths, b2.codes, b2.lengths)

    n_reads = 0
    t_all = time.perf_counter()
    for bi in range(n_batches):
        t = time.perf_counter()
        b1, b2 = next(it)
        tick("fastq_decode", time.perf_counter() - t)
        n_reads += len(b1.lengths) + len(b2.lengths)

        # mirror align_pair_batch with phase timing
        p = eng.params
        bucket = eng._bucket()
        B1 = b1.codes.shape[0]
        L = max(b1.codes.shape[1], b2.codes.shape[1])
        codes = np.full((2 * B1, L), 4, b1.codes.dtype)
        codes[:B1, :b1.codes.shape[1]] = b1.codes
        codes[B1:, :b2.codes.shape[1]] = b2.codes
        lengths = np.concatenate([np.asarray(b1.lengths),
                                  np.asarray(b2.lengths)])

        t = time.perf_counter()
        cands = find_candidates_batch(codes, lengths, idx, p)
        tick("seed+chain", time.perf_counter() - t)

        t = time.perf_counter()
        jr = eng._build_jobs(codes, lengths)
        tick("build_jobs", time.perf_counter() - t)
        j_read, j_rev, j_rlen, j_start, j_wlen, slice_of = jr

        t = time.perf_counter()
        reads8_dev = eng._ship_reads(codes, lengths)
        tick("ship_reads", time.perf_counter() - t)

        from falcon_genome_tpu.ops.smith_waterman import (
            sw_extend_gather, sw_score_gather)
        t = time.perf_counter()
        scores = sw_score_gather(
            reads8_dev, j_read, j_rev, j_rlen, eng.genome_dev,
            j_start, j_wlen, p.sw, bucket)
        tick("sw_score", time.perf_counter() - t)

        t = time.perf_counter()
        win_rows, sub_of = eng._winners_and_subs(
            j_read, j_start, scores, 2 * B1)
        tick("pairing", time.perf_counter() - t)

        t = time.perf_counter()
        results = sw_extend_gather(
            reads8_dev, j_read[win_rows], j_rev[win_rows],
            j_rlen[win_rows], eng.genome_dev, j_start[win_rows],
            j_wlen[win_rows], p.sw, bucket)
        tick("sw_extend", time.perf_counter() - t)

        t = time.perf_counter()
        best = [None] * (2 * B1)
        from falcon_genome_tpu.aligner import Alignment
        for b in range(2 * B1):
            best[b] = Alignment(mapped=False, read_len=int(lengths[b]))
        for row, res in zip(win_rows, results):
            if res.score <= 0:
                continue
            b = int(j_read[row])
            best[b] = eng._alignment_from(
                codes, lengths, b, bool(j_rev[row]), int(j_start[row]),
                res, int(sub_of[b]))
        tick("aln_from(NM)", time.perf_counter() - t)

        t = time.perf_counter()
        alignments_to_columns(b1, best[:B1], b2, best[B1:],
                              params=p, read_group="rg0")
        tick("emit_columns", time.perf_counter() - t)

    total = time.perf_counter() - t_all
    print(f"\n{n_reads} reads in {total:.2f}s = {n_reads/total:.0f} "
          "reads/s (serial phases, no overlap)")
    for k, v in sorted(T.items(), key=lambda kv: -kv[1]):
        print(f"  {k:<14} {v:7.2f}s  {100*v/total:5.1f}%")
    print(f"  {'(untimed)':<14} {total-sum(T.values()):7.2f}s")


if __name__ == "__main__":
    main()
