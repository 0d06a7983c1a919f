"""``indel`` stage: legacy indel realignment.

Mirrors the reference's RTCWorker → IndelWorker chain (SURVEY.md §2
row 22, src/workers/IndelWorker.cpp): RealignerTargetCreator finds
indel-evidence targets; IndelRealigner re-aligns reads over them.

Here target discovery is the active-region detector (indel-weighted) and
realignment is a batched Smith-Waterman of each overlapping read against
the target's reference window — reads whose fresh alignment scores
strictly better get their position/CIGAR rewritten.  (GATK4 dropped this
stage because haplotype-based calling subsumes it; it is provided for
reference-pipeline parity.)

The data plane is the shared columnar input (BamInputSource): shards
stream via the ``.bai`` index at scale, record objects materialize only
per shard for the irregular target/realign work, and the realigned
columns merge through one coordinate sort — the same per-contig scatter
the reference runs (IndelWorker ×ncontigs with ``-L``; like GATK's
``-L``, unmapped reads fall outside every interval).
"""
from __future__ import annotations

import logging

import numpy as np

from ..config import Config
from ..io.bam import write_bam_columns
from ..io.columns import RecordColumns
from ..io.dna import encode_seq
from ..io.sam import CIGAR_D, CIGAR_I, CIGAR_M, CIGAR_S, cigar_to_str
from ..models.activeregion import ActiveRegionParams, find_active_regions
from ..ops.smith_waterman import SWBucket, sw_extend_batch
from ..ops.sw_ref import SWParams
from ..pipeline.runner import PipelineRunner, stage
from ..utils.common import check_output
from .bamstages import BamInputSource
from .common import interval_shards, load_fasta

log = logging.getLogger("falcon_genome_tpu")


def _realign_interval(reads, codes: np.ndarray, lo0: int, hi0: int,
                      params: SWParams) -> int:
    """RTC + realignment over one interval's reads (in place)."""
    live = [r for r in reads if not r.is_unmapped
            and r.seq not in ("*", "")]
    if not live:
        return 0
    targets = find_active_regions(
        live, codes, lo0, hi0, ActiveRegionParams(threshold=0.05, pad=40))
    n_realigned = 0
    for lo, hi in targets:
        # every read overlapping the target is a candidate: misaligned
        # reads typically carry plain mismatch-dense M CIGARs — the
        # strict score comparison below keeps only true improvements
        cand = [r for r in live if r.pos < hi and r.end_pos > lo]
        if not cand:
            continue
        win = codes[lo:hi]
        maxr = max(len(r.seq) for r in cand)
        R = ((maxr + 31) // 32) * 32
        W = ((len(win) + 127) // 128) * 128
        rarr = np.full((len(cand), maxr), 4, np.uint8)
        rl = np.zeros(len(cand), np.int32)
        for i, r in enumerate(cand):
            s = encode_seq(r.seq)
            rarr[i, :len(s)] = s
            rl[i] = len(s)
        wins = np.tile(win, (len(cand), 1)).astype(np.uint8)
        wl = np.full(len(cand), len(win), np.int32)
        bucket = SWBucket(max_read_len=R, max_win_len=W)
        results = sw_extend_batch(rarr, rl, wins, wl, params, bucket)
        for r, res in zip(cand, results):
            if res.score <= 0:
                continue
            old_score = _score_current(r, codes, params)
            if res.score > old_score:
                r.set_tag("OC", "Z", cigar_to_str(r.cigar))
                r.pos = lo + res.ref_start
                r.cigar = res.cigar
                n_realigned += 1
    return n_realigned


def _activity_columns(cols: RecordColumns, codes: np.ndarray,
                      lo0: int, hi0: int
                      ) -> tuple[np.ndarray, np.ndarray]:
    """(events, depth) over [lo0, hi0) — the columnar twin of
    models.activeregion.pileup_activity (same votes: mismatch 1, indel
    1.5, soft-clip 0.5; duplicates/secondary/supplementary skipped)."""
    from ..io.columns import (
        F_FLAG, F_LSEQ, F_POS, expand_cigar_ops, expand_match_bases,
        seq_codes_blob)
    from ..io.sam import FLAG_DUP, FLAG_UNMAPPED

    n = hi0 - lo0
    depth_d = np.zeros(n + 1, np.int32)
    events_d = np.zeros(n + 1, np.float32)
    events = np.zeros(n, np.float32)
    f = cols.fixed
    elig = np.flatnonzero(
        (f[:, F_FLAG] & (FLAG_UNMAPPED | FLAG_DUP | 0x900)) == 0)
    if not len(elig):
        return events, depth_d[:n]
    seq_blob = seq_codes_blob(cols)

    CH = 200_000
    for c0 in range(0, len(elig), CH):
        sel = elig[c0:c0 + CH]
        ops, lens, op_rec, qoff, roff = expand_cigar_ops(cols, sel)
        rpos = f[sel, F_POS].astype(np.int64)[op_rec] + roff
        # depth + D-events over ranges via difference arrays
        for opc, diff, w in ((CIGAR_M, depth_d, 1),
                             (CIGAR_D, events_d, 1.5)):
            m = ops == opc
            lo = np.clip(rpos[m], lo0, hi0) - lo0
            hi = np.clip(rpos[m] + lens[m], lo0, hi0) - lo0
            np.add.at(diff, lo, w)
            np.add.at(diff, hi, -w)
        # I / S point events
        for opc, w in ((CIGAR_I, 1.5), (CIGAR_S, 0.5)):
            m = ops == opc
            p = rpos[m]
            p = p[(p >= lo0) & (p < hi0)] - lo0
            np.add.at(events, p, w)
        # per-base mismatches along M runs
        has = f[sel, F_LSEQ] > 0
        sel2_local = np.flatnonzero(has)
        if len(sel2_local):
            sel2 = sel[sel2_local]
            rec, qpos, bpos = expand_match_bases(cols, sel2)
            ok = (bpos >= lo0) & (bpos < hi0)
            rec, qpos, bpos = rec[ok], qpos[ok], bpos[ok]
            base = seq_blob[cols.seq_off[sel2][rec] + qpos]
            mism = (base != codes[bpos]) & (base != 4)
            np.add.at(events, bpos[mism] - lo0, 1.0)
    depth = np.cumsum(depth_d[:n])
    events += np.cumsum(events_d[:n])
    return events, depth


def _current_scores(cols: RecordColumns, codes: np.ndarray,
                    rows: np.ndarray, p: SWParams) -> np.ndarray:
    """Vectorized ``_score_current`` over ``rows``."""
    from ..io.columns import (
        expand_cigar_ops, expand_match_bases, seq_codes_blob)
    from ..io.sam import CIGAR_D, CIGAR_I, CIGAR_M
    ops, lens, op_rec, _, _ = expand_cigar_ops(cols, rows)
    score = np.zeros(len(rows), np.int64)
    gap = (ops == CIGAR_I) | (ops == CIGAR_D)
    np.subtract.at(score, op_rec[gap],
                   p.gap_open + lens[gap] * p.gap_ext)
    rec, qpos, bpos = expand_match_bases(cols, rows)
    ok = bpos < len(codes)          # contig-end clamp (min-len semantics)
    rec, qpos, bpos = rec[ok], qpos[ok], bpos[ok]
    seq_blob = seq_codes_blob(cols)
    base = seq_blob[cols.seq_off[rows][rec] + qpos]
    mism = base != codes[bpos]
    np.add.at(score, rec, np.where(mism, -p.mismatch, p.match))
    return score


def _realign_columns(cols: RecordColumns, codes: np.ndarray, lo0: int,
                     hi0: int, params: SWParams,
                     genome_dev=None) -> int:
    """Columnar RTC + realignment over one interval (mutates ``cols``).

    Replaces the per-target python loop (record objects, one device
    dispatch + compile variant per target) with ONE columnar activity
    pileup, ONE candidate-overlap join and batched window-gather SW over
    every (read, target) pair — the per-target path was dominated by
    object churn and per-target device syncs at WGS scale.
    ``_realign_interval`` (records) remains the semantics reference;
    tests assert record-equal output."""
    from ..io.columns import F_ENDPOS, F_FLAG, F_LSEQ, F_NCIGAR, F_POS
    from ..io.sam import FLAG_UNMAPPED
    from ..models.activeregion import regions_from_activity
    from ..ops.smith_waterman import sw_extend_gather, device_genome, \
        device_reads

    f = cols.fixed
    live = np.flatnonzero(((f[:, F_FLAG] & FLAG_UNMAPPED) == 0)
                          & (f[:, F_LSEQ] > 0))
    if not len(live):
        return 0
    events, depth = _activity_columns(cols, codes, lo0, hi0)
    targets = regions_from_activity(
        events, depth, lo0, len(codes),
        ActiveRegionParams(threshold=0.05, pad=40))
    if not targets:
        return 0

    pos = f[live, F_POS].astype(np.int64)
    end = f[live, F_ENDPOS].astype(np.int64)
    order = np.argsort(pos, kind="stable")
    pos_s = pos[order]
    maxspan = int((end - pos).max(initial=0))
    t_lo = np.asarray([t[0] for t in targets], np.int64)
    t_hi = np.asarray([t[1] for t in targets], np.int64)
    a = np.searchsorted(pos_s, t_lo - maxspan, "left")
    b = np.searchsorted(pos_s, t_hi, "left")
    cnt = b - a
    # (candidate row, target) pairs, target-major like the serial loop
    tgt = np.repeat(np.arange(len(targets)), cnt)
    lrow = (np.repeat(a, cnt) + np.arange(int(cnt.sum()))
            - np.repeat(np.cumsum(cnt) - cnt, cnt))
    rows_l = order[lrow]
    keep = (end[rows_l] > t_lo[tgt]) & (pos[rows_l] < t_hi[tgt])
    tgt, rows_l = tgt[keep], rows_l[keep]
    if not len(tgt):
        return 0
    rows = live[rows_l]                      # absolute record rows

    # one resident read matrix + window-gather SW over all pairs
    from ..io.columns import seq_codes_blob
    seq_blob = seq_codes_blob(cols)
    urows, uinv = np.unique(rows, return_inverse=True)
    rl_u = f[urows, F_LSEQ].astype(np.int32)
    R = 160 if int(rl_u.max()) <= 160 else int(
        (int(rl_u.max()) + 31) // 32 * 32)
    W = 384
    bucket = SWBucket(max_read_len=R, max_win_len=W)
    reads_pad = np.full((len(urows), R), 4, np.uint8)
    for i, r in enumerate(urows):            # ragged gather, ~unique rows
        o = cols.seq_off[r]
        reads_pad[i, :rl_u[i]] = seq_blob[o:o + rl_u[i]]
    reads8_dev = device_reads(reads_pad)
    if genome_dev is None:
        genome_dev = device_genome(codes)
    wlen = (t_hi - t_lo)[tgt].astype(np.int32)
    results = sw_extend_gather(
        reads8_dev, uinv.astype(np.int32), np.zeros(len(tgt), bool),
        rl_u[uinv], genome_dev, t_lo[tgt].astype(np.int32), wlen,
        params, bucket)
    new_scores = np.fromiter((r.score for r in results), np.int64,
                             len(results))

    cur = np.zeros(len(cols), np.int64)
    cur[urows] = _current_scores(cols, codes, urows, params)

    # per row: best new score over its targets; first target on ties —
    # the serial per-target loop's fixpoint (strict > keeps the earliest
    # equal-scoring rewrite)
    o2 = np.lexsort((tgt, -new_scores, rows))
    first = np.ones(len(o2), bool)
    first[1:] = rows[o2][1:] != rows[o2][:-1]
    win = o2[first]
    win = win[new_scores[win] > cur[rows[win]]]
    if not len(win):
        return 0

    # ---- rewrite the winning rows in place --------------------------------
    imp_rows = rows[win]
    res_by_row = {int(r): results[int(w)] for r, w in zip(imp_rows, win)}
    lo_by_row = {int(r): int(t_lo[tgt[w]]) for r, w in zip(imp_rows, win)}

    ncig = f[:, F_NCIGAR].astype(np.int64)
    new_cigs = {r: res_by_row[r].cigar for r in res_by_row}
    ncig_new = ncig.copy()
    for r, cg in new_cigs.items():
        ncig_new[r] = len(cg)
    cig_off_new = np.zeros(len(cols), np.int64)
    np.cumsum(ncig_new[:-1], out=cig_off_new[1:])
    total = int(ncig_new.sum())
    ops_new = np.zeros(total, np.int32)
    lens_new = np.zeros(total, np.int32)
    unchanged = np.ones(len(cols), bool)
    unchanged[imp_rows] = False
    un = np.flatnonzero(unchanged & (ncig > 0))
    if len(un):
        nc_u = ncig[un]
        src = (np.repeat(cols.cig_off[un].astype(np.int64), nc_u)
               + np.arange(int(nc_u.sum()))
               - np.repeat(np.cumsum(nc_u) - nc_u, nc_u))
        dst = (np.repeat(cig_off_new[un], nc_u)
               + np.arange(int(nc_u.sum()))
               - np.repeat(np.cumsum(nc_u) - nc_u, nc_u))
        ops_new[dst] = cols.cigar_ops[src]
        lens_new[dst] = cols.cigar_lens[src]
    tag_parts = [cols.tags]
    tag_end = len(cols.tags)
    tag_off = cols.tag_off.copy()
    tag_len = cols.tag_len.copy()
    for r in imp_rows:
        r = int(r)
        res = res_by_row[r]
        o = cig_off_new[r]
        for t, (op, ln) in enumerate(res.cigar):
            ops_new[o + t] = op
            lens_new[o + t] = ln
        # OC:Z:<old cigar>, appended after the record's existing tags
        old = cols.cigar_ops[cols.cig_off[r]:cols.cig_off[r] + ncig[r]]
        oldl = cols.cigar_lens[cols.cig_off[r]:cols.cig_off[r] + ncig[r]]
        oc = cigar_to_str(list(zip(old.tolist(), oldl.tolist())))
        span = (cols.tags[tag_off[r]:tag_off[r] + tag_len[r]].tobytes()
                + b"OCZ" + oc.encode() + b"\x00")
        tag_parts.append(np.frombuffer(span, np.uint8))
        tag_off[r] = tag_end
        tag_len[r] = len(span)
        tag_end += len(span)
        new_pos = lo_by_row[r] + res.ref_start
        f[r, F_POS] = new_pos
        ref_span = sum(n for op, n in res.cigar
                       if op in (0, 2, 3, 7, 8))
        f[r, F_ENDPOS] = new_pos + ref_span
        f[r, F_NCIGAR] = len(res.cigar)
    cols.cigar_ops = ops_new
    cols.cigar_lens = lens_new
    cols.cig_off = cig_off_new
    cols.tags = np.concatenate(tag_parts)
    cols.tag_off = tag_off
    cols.tag_len = tag_len
    return len(imp_rows)


def run_indel(conf: Config, ref: str, input_path: str, output: str,
              force: bool = False,
              extra_opts: list[str] | None = None) -> str:
    from ..utils.extraopts import ExtraOpts
    xo = ExtraOpts(extra_opts)
    xo.warn_unused("indel")
    output = check_output(output, force)
    fa = load_fasta(ref)
    src = BamInputSource.from_conf(conf, input_path)
    header = src.header
    params = SWParams()
    shards = [s for s in interval_shards(conf, fa) if s]
    runner = PipelineRunner.from_conf("Indel Realignment", conf,
                                      force=force)
    from pathlib import Path

    from ..utils.common import get_contig_fname
    parts_root = Path(str(output) + ".parts")
    part_paths = [get_contig_fname(str(parts_root), i, "bam")
                  for i in range(len(shards))]

    genome_dev_cache: dict[str, object] = {}

    def one(shard, idx):
        from ..ops.smith_waterman import device_genome
        parts = []
        n_re = 0
        for iv in shard:
            if iv.contig not in fa.dict.by_name:
                continue
            # by_start: a partition — each record realigns in exactly
            # one shard and is emitted once
            cols = src.columns_for([iv], by_start=True)
            if len(cols) == 0:
                continue
            codes = fa.contig_codes(iv.contig)
            if iv.contig not in genome_dev_cache:
                genome_dev_cache[iv.contig] = device_genome(codes)
            n_re += _realign_columns(cols, codes, iv.start - 1, iv.end,
                                     params,
                                     genome_dev=genome_dev_cache[iv.contig])
            parts.append(cols)
        import os
        parts_root.mkdir(parents=True, exist_ok=True)
        out_cols = (RecordColumns.concat(parts) if parts
                    else RecordColumns.from_records([]))
        path = part_paths[idx]
        tmp = path + ".tmp.bam"
        write_bam_columns(tmp, header, out_cols,
                          order=out_cols.coordinate_order(), index=False)
        os.replace(tmp, path)
        return path, n_re

    tasks = [(lambda s=s, i=i: one(s, i)) for i, s in enumerate(shards)]
    (results,) = runner.run([stage(
        "IndelRealigner", tasks, outputs=part_paths,
        nprocs=conf.get("gatk.nprocs"))]).values()
    n_realigned = sum(r[1] for r in results if isinstance(r, tuple))
    # shard-by-shard streamed merge: one part resident at a time; the
    # slack window absorbs realignment moves across shard boundaries
    # (bounded by the active-region pad)
    import shutil

    from .bamstages import stream_merge_sorted_parts
    next_keys = [
        (header.tid(shards[i + 1][0].contig),
         shards[i + 1][0].start - 1) if i + 1 < len(shards) else None
        for i in range(len(shards))]
    stream_merge_sorted_parts(output, header, part_paths, next_keys)
    shutil.rmtree(parts_root, ignore_errors=True)
    log.info("indel: %d reads realigned → %s", n_realigned, output)
    return output


def _lead_clip(cigar) -> int:
    return cigar[0][1] if cigar and cigar[0][0] == CIGAR_S else 0


def _score_current(rec, codes: np.ndarray, p: SWParams) -> int:
    """Score the read's existing alignment under the SW scoring scheme."""
    from ..io.sam import CIGAR_D, CIGAR_I, CIGAR_M
    seq = encode_seq(rec.seq)
    score = 0
    i, rpos = 0, rec.pos
    for op, n in rec.cigar:
        if op == CIGAR_M:
            seg = seq[i:i + n]
            refseg = codes[rpos:rpos + n]
            m = min(len(seg), len(refseg))
            match = int((seg[:m] == refseg[:m]).sum())
            score += match * p.match - (m - match) * p.mismatch
            i += n
            rpos += n
        elif op == CIGAR_I:
            score -= p.gap_open + n * p.gap_ext
            i += n
        elif op == CIGAR_D:
            score -= p.gap_open + n * p.gap_ext
            rpos += n
        elif op == CIGAR_S:
            i += n
    return score
