"""Long-read aligner (minimap2-class): minimizer anchors → gap-cost
chaining → checkpointed piecewise Smith-Waterman on the device.

Replaces the reference's shelled-out ``minimap-flow`` binary
(src/workers/Minimap2Worker.cpp:51-106; selected by the fast-germline
driver, src/worker-germline.cpp:191) with an in-repo design:

* **anchors** reuse the short-read path's minimizer index
  (:class:`~falcon_genome_tpu.aligner.MinimizerIndex`) at long-read
  parameters (k=19, w=10 — the minimap2 map-ont neighborhood);
* **chaining** is the minimap2 gap-cost DP (bounded-lookback, score
  ``min(dq, dr, k) − gapcost``), vectorized over anchors on the host —
  a serial scan over at most a few thousand anchors per read;
* **base-level alignment** runs on the device: the chain is cut into
  checkpointed chunks (anchor-pinned boundaries are exact k-mer
  correspondences), every chunk of every read in the batch becomes one
  lane of a single batched SW kernel call (ops/smith_waterman.py), and
  chunk CIGARs concatenate exactly at the pinned boundaries.  Local-SW
  edge clipping at a pinned boundary is patched with M/I/D so
  coordinates stay exact (the patch can only make the reported score
  pessimistic, never the position wrong);
* long reads have no proper-pair model — records emit single-end, like
  minimap2's map-ont preset.

A prebuilt serialized index (``<ref>.mmi.npz`` — the ``.mmi`` analog the
reference probes at Minimap2Worker.cpp check(): get_fname_by_ext(ref,
"mmi")) is loaded by the align stage when present.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .aligner import (
    Alignment, IndexParams, MinimizerIndex, _edit_distance, _minimizers)
from .io.dna import revcomp_codes
from .io.sam import CIGAR_D, CIGAR_I, CIGAR_M, CIGAR_S, Cigar
from .ops.smith_waterman import SWBucket, sw_extend_batch
from .ops.sw_ref import SWParams, SWResult


@dataclasses.dataclass
class LongReadParams:
    index: IndexParams = dataclasses.field(
        default_factory=lambda: IndexParams(k=19, w=10, max_hits=256))
    sw: SWParams = dataclasses.field(default_factory=SWParams)
    max_gap: int = 5000        # max read/ref gap between chainable anchors
    lookback: int = 64         # chaining DP predecessors examined
    min_anchors: int = 3
    min_chain_score: int = 40
    chunk_read: int = 144      # piecewise-SW read-chunk budget (160 bucket)
    chunk_win: int = 240       # ref window budget per chunk (256 bucket)
    end_pad: int = 48          # ref slack at the free read ends


# ---------------------------------------------------------------------------
# chaining (minimap2 §2.1: gap-cost DP with bounded lookback)
# ---------------------------------------------------------------------------

def chain_anchors(q: np.ndarray, r: np.ndarray, k: int,
                  params: LongReadParams
                  ) -> tuple[np.ndarray, float, float]:
    """Best anchor chain for one read+strand.

    ``q``/``r``: read / global-ref positions of anchors (same strand,
    oriented-read coordinates).  Returns (indices of the best chain in
    ascending order, its score, the best non-overlapping other score —
    for mapq).  Scoring: each extension gains ``min(dq, dr, k)`` minus
    the minimap2 gap cost ``0.01·k·|dr−dq| + 0.5·log2(|dr−dq|+1)``.
    """
    n = len(q)
    if n == 0:
        return np.zeros(0, np.int64), 0.0, 0.0
    order = np.lexsort((q, r))
    qs, rs = q[order].astype(np.int64), r[order].astype(np.int64)
    L = min(params.lookback, n)
    from .io import native_ext
    nat = native_ext.chain_anchors(qs, rs, k, L, params.max_gap)
    if nat is not None:
        f, parent, end = nat
    else:
        # python golden model of fg_chain_anchors: vectorized over the
        # lookback window, serial over anchors
        f = np.full(n, float(k))
        parent = np.full(n, -1, np.int64)
        for i in range(1, n):
            j0 = max(0, i - L)
            dq = qs[i] - qs[j0:i]
            dr = rs[i] - rs[j0:i]
            gap = np.abs(dr - dq)
            ok = (dq > 0) & (dr > 0) & (dq <= params.max_gap) \
                & (dr <= params.max_gap)
            if not ok.any():
                continue
            gain = np.minimum(np.minimum(dq, dr), k).astype(np.float64) \
                - 0.01 * k * gap - 0.5 * np.log2(gap + 1.0)
            cand = np.where(ok, f[j0:i] + gain, -np.inf)
            b = int(np.argmax(cand))
            if cand[b] > f[i]:
                f[i] = cand[b]
                parent[i] = j0 + b
        end = int(np.argmax(f))
    chain = []
    i = end
    while i >= 0:
        chain.append(i)
        i = int(parent[i])
    chain.reverse()
    # second-best = best chain at a DIFFERENT locus: anchors near the
    # primary's ref span belong to the same placement (their f trails the
    # primary by construction) and must not drag mapq to zero
    ref_lo, ref_hi = int(rs[chain[0]]), int(rs[chain[-1]])
    span = max(int(qs[chain[-1]]) + k, 1)
    away = (rs < ref_lo - span) | (rs > ref_hi + span)
    other = float(f[away].max()) if away.any() else 0.0
    return order[np.asarray(chain, np.int64)], float(f[end]), other


# ---------------------------------------------------------------------------
# checkpointed piecewise alignment
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Chunk:
    read_a: int       # oriented-read span [read_a, read_b)
    read_b: int
    ref_a: int        # absolute (global) ref span [ref_a, ref_b)
    ref_b: int
    free_left: bool   # free read end (keep soft clip, shifts pos)
    free_right: bool


def _checkpoints(cq: np.ndarray, cr: np.ndarray, k: int, L: int,
                 genome_len: int, params: LongReadParams
                 ) -> list[_Chunk]:
    """Cut a chain into SW chunks.

    Checkpoints are chain anchors (exact k-mer correspondences); a chunk
    spans checkpoint→checkpoint inclusive of the closing anchor's k-mer,
    so consecutive chunks abut at exact read↔ref correspondences.  Long
    inter-anchor gaps are chopped proportionally (boundaries approximate
    — the SW edge patch restores the pin).  Virtual checkpoints extend
    the chain to the read ends along the local diagonal.
    """
    first_q, first_r = int(cq[0]), int(cr[0])
    last_q, last_r = int(cq[-1]), int(cr[-1])
    # virtual start: project read base 0 on the first anchor's diagonal
    r0 = max(0, first_r - first_q)
    # closing anchor consumes its k-mer; then project the read tail
    rend = min(genome_len, last_r + k + (L - (last_q + k)))

    # strictly-increasing point list.  The chain anchors are already
    # strictly increasing in both coordinates (_chain_read's keep
    # filter), so the sequential monotone scan reduces to: skip leading
    # anchors not strictly beyond the virtual start (once one anchor
    # passes, all later ones do), and test the virtual end against the
    # last kept point.  _assemble soft-clips any read tail left
    # uncovered when the genome end clamps the projection.
    s = 0
    n = len(cq)
    while s < n and not (int(cq[s]) > 0 and int(cr[s]) > r0):
        s += 1
    lq, lr = (int(cq[-1]), int(cr[-1])) if s < n else (0, r0)
    tail = [L] if (L > lq and rend > lr) else []
    pts_q = np.concatenate([[0], cq[s:], tail]).astype(np.int64)
    pts_r = np.concatenate(
        [[r0], cr[s:], [rend] if tail else []]).astype(np.int64)
    if len(pts_q) < 2:
        return []

    chunks: list[_Chunk] = []
    budget_q = params.chunk_read
    budget_r = params.chunk_win
    npts = len(pts_q)
    # list + bisect: the loop makes two tiny binary searches per chunk,
    # where np.searchsorted's per-call overhead dominated the walk
    import bisect
    pq = pts_q.tolist()
    pr_ = pts_r.tolist()
    i = 0
    while i < npts - 1:
        qa, ra = pq[i], pr_[i]
        # greedily absorb checkpoints while the chunk fits both budgets
        # (points increase in both coords → two binary searches)
        j = min(bisect.bisect_right(pq, qa + budget_q),
                bisect.bisect_right(pr_, ra + budget_r)) - 1
        j = max(j, i + 1)
        j = min(j, npts - 1)
        qb, rb = int(pts_q[j]), int(pts_r[j])
        dq, dr = qb - qa, rb - ra
        if dq > budget_q or dr > budget_r:
            # single long inter-checkpoint gap: proportional chop
            nsp = max(int(np.ceil(dq / budget_q)),
                      int(np.ceil(dr / budget_r)))
            for sp in range(nsp):
                sqa = qa + dq * sp // nsp
                sqb = qa + dq * (sp + 1) // nsp
                sra = ra + dr * sp // nsp
                srb = ra + dr * (sp + 1) // nsp
                chunks.append(_Chunk(sqa, sqb, sra, srb,
                                     free_left=(i == 0 and sp == 0),
                                     free_right=(j == npts - 1
                                                 and sp == nsp - 1)))
        else:
            chunks.append(_Chunk(qa, qb, ra, rb,
                                 free_left=(i == 0),
                                 free_right=(j == npts - 1)))
        i = j
    return [c for c in chunks if c.read_b > c.read_a and c.ref_b >= c.ref_a]


def _merge_cigar(out: Cigar, op: int, n: int) -> None:
    if n <= 0:
        return
    if out and out[-1][0] == op:
        out[-1] = (op, out[-1][1] + n)
    else:
        out.append((op, n))


def _assemble(chunks: list[_Chunk], results: list[SWResult],
              read_len: int) -> tuple[Cigar, int, int] | None:
    """Object-form adapter over ``_assemble_rows`` (tests/golden path)."""
    mo = max((len(r.cigar) for r in results), default=1) or 1
    n = len(results)
    ops_a = np.zeros((n, mo), np.int32)
    lens_a = np.zeros((n, mo), np.int32)
    nc = np.zeros(n, np.int32)
    coords = np.zeros((4, n), np.int64)
    best = np.zeros(n, np.int64)
    for i, r in enumerate(results):
        best[i] = r.score
        coords[:, i] = (r.read_start, r.ref_start, r.read_end, r.ref_end)
        nc[i] = len(r.cigar)
        for t, (op, ln) in enumerate(r.cigar):
            ops_a[i, t], lens_a[i, t] = op, ln
    return _assemble_rows(chunks, 0, (ops_a, lens_a, nc, coords, best),
                          read_len)


def _assemble_rows(chunks: list[_Chunk], r0: int, arrs,
                   read_len: int) -> tuple[Cigar, int, int] | None:
    """Concatenate chunk alignments → (oriented CIGAR, abs ref begin,
    total score).  Pinned chunk edges that local SW clipped are patched
    with M (+ I/D remainder) so checkpoint correspondences stay exact.
    Consumes the RLE slot arrays directly (rows r0..r0+len(chunks)) —
    no SWResult object per chunk."""
    ops_a, lens_a, nc, coords, best = arrs
    cigar: Cigar = []
    score = 0
    ref_begin = None
    lead_uncovered = chunks[0].read_a if chunks else 0
    for ci, c in enumerate(chunks):
        r = r0 + ci
        seg_q = c.read_b - c.read_a
        seg_r = c.ref_b - c.ref_a
        if best[r] <= 0:
            if ref_begin is None:
                # still unanchored: soft-clip and keep looking
                _merge_cigar(cigar, CIGAR_S, seg_q)
                continue
            # chunk failed to align: bridge it coordinate-exactly
            m = min(seg_q, seg_r)
            _merge_cigar(cigar, CIGAR_M, m)
            _merge_cigar(cigar, CIGAR_I, seg_q - m)
            _merge_cigar(cigar, CIGAR_D, seg_r - m)
            continue
        score += int(best[r])
        # leading edge
        lead_q = int(coords[0, r])
        lead_r = int(coords[1, r])
        if c.free_left and ref_begin is None:
            _merge_cigar(cigar, CIGAR_S, lead_q)
            ref_begin = c.ref_a + lead_r
        else:
            if ref_begin is None:
                ref_begin = c.ref_a + lead_r  # first scoring chunk pins
                _merge_cigar(cigar, CIGAR_S, lead_q)
            else:
                m = min(lead_q, lead_r)
                _merge_cigar(cigar, CIGAR_M, m)
                _merge_cigar(cigar, CIGAR_I, lead_q - m)
                _merge_cigar(cigar, CIGAR_D, lead_r - m)
        # aligned body (strip the soft clips the local SW emitted)
        ro = ops_a[r]
        rl_ = lens_a[r]
        for t in range(int(nc[r])):
            if ro[t] != CIGAR_S:
                _merge_cigar(cigar, int(ro[t]), int(rl_[t]))
        # trailing edge
        tail_q = seg_q - int(coords[2, r])
        tail_r = seg_r - int(coords[3, r])
        if c.free_right:
            _merge_cigar(cigar, CIGAR_S, tail_q)
        else:
            m = min(tail_q, tail_r)
            _merge_cigar(cigar, CIGAR_M, m)
            _merge_cigar(cigar, CIGAR_I, tail_q - m)
            _merge_cigar(cigar, CIGAR_D, tail_r - m)
    if ref_begin is None:
        return None
    if lead_uncovered:
        cigar.insert(0, (CIGAR_S, lead_uncovered))
    # coverage invariant: the CIGAR must consume exactly the read — a
    # genome-end clamp can leave a tail uncovered; soft-clip it
    consumed = sum(n for op, n in cigar
                   if op in (CIGAR_M, CIGAR_I, CIGAR_S))
    if consumed < read_len:
        _merge_cigar(cigar, CIGAR_S, read_len - consumed)
    elif consumed > read_len:
        return None   # malformed chunk plan: refuse rather than emit junk
    return cigar, ref_begin, score


def _long_mapq(best: float, second: float, n_anchors: int) -> int:
    """minimap2-flavor mapq from chain-score separation."""
    if best <= 0:
        return 0
    ratio = max(0.0, 1.0 - second / best)
    q = 40.0 * ratio * min(1.0, n_anchors / 10.0)
    return int(max(0, min(60, round(q))))


class LongReadAligner:
    """Aligns variable-length long reads against a MinimizerIndex."""

    def __init__(self, index: MinimizerIndex,
                 params: LongReadParams | None = None,
                 bucket: SWBucket | None = None):
        self.index = index
        self.params = params or LongReadParams()
        self.bucket = bucket or SWBucket(max_read_len=160, max_win_len=256)

    def _lookup_batch(self, reads: list[np.ndarray]):
        """ONE index lookup for a whole sub-batch's minimizers.

        Per-read ``index.lookup`` walked the (88 MB at 60 Mb) sorted
        hash array cache-cold once per read — the sorted-probe batch
        walk is coherent and was ~40% of the steady-state wall.
        Returns per-read (rp, rstrand, gpos, gstrand) hit arrays."""
        k, w = self.index.params.k, self.index.params.w
        hs, rps, rss, nm = [], [], [], []
        for codes in reads:
            h, rp, rs = _minimizers(np.asarray(codes, np.uint8), k, w)
            hs.append(h)
            rps.append(rp)
            rss.append(rs)
            nm.append(len(h))
        if not hs:
            return []
        H = np.concatenate(hs)
        out: list[tuple] = []
        if len(H) == 0:
            return [(np.zeros(0, np.int64), np.zeros(0, bool),
                     np.zeros(0, np.int64), np.zeros(0, bool))] * len(reads)
        qidx, gpos, gstrand = self.index.lookup(H)
        RP = np.concatenate(rps)[qidx]
        RS = np.concatenate(rss)[qidx]
        # hits are in ascending minimizer order → grouped by read
        bounds = np.concatenate([[0], np.cumsum(nm)])
        splits = np.searchsorted(qidx, bounds)
        for ri in range(len(reads)):
            a, b = splits[ri], splits[ri + 1]
            out.append((RP[a:b], RS[a:b], gpos[a:b], gstrand[a:b]))
        return out

    def _chain_read(self, codes: np.ndarray, hits=None):
        """Best chain over both strands → (is_rev, oriented codes,
        chain read/ref arrays, score, runner-up score) or None."""
        p = self.params
        k, w = self.index.params.k, self.index.params.w
        if hits is None:
            h, rpos, rstrand = _minimizers(codes, k, w)
            if len(h) == 0:
                return None
            qidx, gpos, gstrand = self.index.lookup(h)
            rp = rpos[qidx]
            rs_h = rstrand[qidx]
        else:
            rp, rs_h, gpos, gstrand = hits
        if len(rp) == 0:
            return None
        L = len(codes)
        rev = gstrand != rs_h
        # oriented-read anchor coordinates (see aligner.find_candidates)
        q_or = np.where(rev, L - k - rp, rp)
        best = None
        scores = []
        for is_rev in (False, True):
            sel = rev == is_rev
            if not sel.any():
                scores.append(0.0)
                continue
            chain_idx, sc, other = chain_anchors(
                q_or[sel], gpos[sel], k, p)
            scores.append(sc)
            if len(chain_idx) < p.min_anchors or sc < p.min_chain_score:
                continue
            if best is None or sc > best[3]:
                cq = q_or[sel][chain_idx]
                cr = gpos[sel][chain_idx]
                best = (is_rev, cq, cr, sc, other)
        if best is None:
            return None
        is_rev, cq, cr, sc, other = best
        # opposite strand's best chain competes too
        second = max(other, scores[0 if is_rev else 1])
        # enforce strictly increasing checkpoints in both coordinates
        keep = [0]
        for i in range(1, len(cq)):
            if cq[i] > cq[keep[-1]] and cr[i] > cr[keep[-1]]:
                keep.append(i)
        cq, cr = cq[keep], cr[keep]
        oriented = revcomp_codes(codes) if is_rev else codes
        return is_rev, oriented, cq, cr, sc, second

    # reads per pipeline stage (device ∥ host overlap): each device call
    # has a fixed cost, so large sub-batches beat finer overlap;
    # production batches (tpu.batch.long_reads = 512) still get 2
    # overlapped stages.  Not yet re-tuned on the GPU.
    SUB_BATCH = 256

    def align_batch(self, reads: list[np.ndarray]) -> list[Alignment]:
        """Two-stage pipeline: while the device scores sub-batch i's
        chunks (XLA dispatch is async), the host chains/checkpoints
        sub-batch i+1 and assembles sub-batch i-1 — the same
        host∥device overlap the short-read aligner's two-stage emit
        uses, here inside one call."""
        out: list[Alignment | None] = [None] * len(reads)
        pending = None
        for lo in range(0, max(len(reads), 1), self.SUB_BATCH):
            sub = reads[lo:lo + self.SUB_BATCH]
            if not sub:
                break
            plan, chunks, oriented = self._prep(sub)
            handle = self._run_chunks(chunks, oriented, plan, sub,
                                      dispatch_only=True)
            if pending is not None:
                self._post(out, *pending)
            pending = (lo, sub, plan, chunks, oriented, handle)
        if pending is not None:
            self._post(out, *pending)
        return out  # type: ignore[return-value]

    def _prep(self, reads: list[np.ndarray]):
        """Host stage 1: chain + checkpoint every read of a sub-batch."""
        p = self.params
        k = self.index.params.k
        genome = self.index.genome
        plan = []                  # (is_rev, c0, c1, score, second, n)
        all_chunks: list[_Chunk] = []
        all_oriented: dict[int, np.ndarray] = {}
        batch_hits = self._lookup_batch(
            [np.asarray(c, np.uint8) for c in reads])
        for ri, codes in enumerate(reads):
            got = self._chain_read(np.asarray(codes, np.uint8),
                                   batch_hits[ri])
            if got is None:
                plan.append(None)
                continue
            is_rev, oriented, cq, cr, sc, second = got
            chunks = _checkpoints(cq, cr, k, len(codes), len(genome), p)
            if not chunks:
                plan.append(None)
                continue
            plan.append((is_rev, len(all_chunks),
                         len(all_chunks) + len(chunks), sc, second,
                         len(cq)))
            all_chunks.extend(chunks)
            all_oriented[ri] = oriented
        return plan, all_chunks, all_oriented

    def _post(self, out, lo, reads, plan, all_chunks, all_oriented,
              handle):
        """Host stage 2: collect device results, assemble alignments."""
        from .ops.smith_waterman import sw_extend_collect_arrays
        genome = self.index.genome
        arrs = (sw_extend_collect_arrays(handle) if handle is not None
                else None)
        for ri, codes in enumerate(reads):
            item = plan[ri]
            if item is None:
                out[lo + ri] = Alignment(mapped=False,
                                         read_len=len(codes))
                continue
            is_rev, c0, c1, sc, second, n_anchors = item
            asm = _assemble_rows(all_chunks[c0:c1], c0, arrs,
                                 len(codes))
            if asm is None:
                out[lo + ri] = Alignment(mapped=False,
                                         read_len=len(codes))
                continue
            cigar, ref_begin, score = asm
            tid, pos = self.index.tid_of(ref_begin)
            ref_len = sum(n for op, n in cigar
                          if op in (CIGAR_M, CIGAR_D))
            shim = SWResult(score, 0, len(codes), 0, ref_len, cigar)
            win = genome[ref_begin:ref_begin + ref_len]
            if len(win) < ref_len:  # genome-end clamp: pad, no match
                win = np.concatenate(
                    [win, np.full(ref_len - len(win), 4, np.uint8)])
            nm = _edit_distance(all_oriented[ri], win, shim)
            out[lo + ri] = Alignment(
                mapped=True, tid=tid, pos=pos, is_rev=is_rev,
                score=score, sub_score=int(second),
                mapq=_long_mapq(sc, second, n_anchors),
                cigar=cigar, nm=nm, read_len=len(codes))

    @property
    def genome_dev(self):
        """Reference genome resident in device memory: chunk windows
        gather on device instead of shipping window bytes per SW call."""
        if getattr(self, "_genome_dev", None) is None:
            from .ops.smith_waterman import device_genome
            self._genome_dev = device_genome(self.index.genome)
        return self._genome_dev

    def _run_chunks(self, chunks: list[_Chunk], oriented, plan, reads,
                    dispatch_only: bool = False):
        if not chunks:
            return None if dispatch_only else []
        bucket = self.bucket
        R, W = bucket.max_read_len, bucket.max_win_len
        p = self.params
        genome = self.index.genome
        n = len(chunks)
        creads = np.full((n, R), 4, np.uint8)
        starts = np.zeros(n, np.int32)
        rl = np.zeros(n, np.int32)
        wl = np.zeros(n, np.int32)
        # map chunk row → owning read (plan slices are contiguous)
        owner = np.zeros(n, np.int64)
        for ri, item in enumerate(plan):
            if item is not None:
                owner[item[1]:item[2]] = ri
        for ci, c in enumerate(chunks):
            ocodes = oriented[int(owner[ci])]
            ra, rb = c.ref_a, c.ref_b
            # free-end ref pad, clamped so the window still fits the
            # compiled bucket (pinned boundaries must never be cut off)
            pad_room = max(0, W - (rb - ra))
            if c.free_left:
                ra = max(0, ra - min(p.end_pad, pad_room))
                pad_room = max(0, W - (rb - ra))
            if c.free_right:
                rb = min(len(genome), rb + min(p.end_pad, pad_room))
            # free-end pads shift the chunk-local origin: account by
            # rebasing the chunk to the padded window
            chunks[ci] = _Chunk(c.read_a, c.read_b, ra, rb,
                                c.free_left, c.free_right)
            seg_q = min(c.read_b - c.read_a, R)
            seg_r = min(rb - ra, W)
            creads[ci, :seg_q] = ocodes[c.read_a:c.read_a + seg_q]
            starts[ci] = ra
            rl[ci] = seg_q
            wl[ci] = seg_r
        from .ops.smith_waterman import sw_extend_collect, \
            sw_extend_win_dispatch
        handle = sw_extend_win_dispatch(creads, rl, self.genome_dev,
                                        starts, wl, p.sw, bucket)
        return handle if dispatch_only else sw_extend_collect(handle)
