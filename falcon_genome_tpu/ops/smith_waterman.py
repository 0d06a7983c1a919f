"""Batched local affine Smith-Waterman.

Replaces the banded seed-extension engine of bwa-flow (the FPGA xclbin the
reference loads at src/workers/BWAWorker.cpp:161-166) with an in-process
computation: each lane aligns one read against one reference window.

Design mirrors the PairHMM wavefront (ops/pairhmm.py) in max-plus algebra:

* ``_sw_scan_core`` — anti-diagonal wavefront over (R, B) arrays (read
  position × pair) as a ``lax.scan``, emitting one int8 traceback pointer
  per cell, diagonal-major, plus the best score and its position;
* traceback (``_traceback_core``) walks the pointer array on device and
  returns packed op streams, exactly the split the reference uses between
  FPGA extension and host CIGAR assembly;
* the candidate-ranking pass needs only the best score: on the GPU it runs
  the warp-strip CUDA kernel (``gpu_kernels.sw_score``), on the CPU the
  scan; ``ops/dispatch.py`` chooses.

Pointer byte per cell: bits 0-1 hdir (0 stop, 1 diag, 2 from E/deletion,
3 from F/insertion), bit 2 E-extend, bit 3 F-extend.

Transfer discipline:

* base codes travel as **int8** and are widened on device;
* the reference genome is **resident in device memory** (`device_genome`)
  and candidate windows are gathered on device from int32 start offsets —
  the host never ships window bytes (`sw_score_gather` /
  `sw_extend_gather`);
* each read is shipped **once per batch** (`device_reads`) and fanned out to
  its candidate lanes on device, including on-device reverse-complement;
* the score-only pass ranks candidates; the full SW runs only on winners;
* traceback op streams come back packed 4 ops/byte.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..io.sam import CIGAR_S, Cigar
from . import dispatch
from .sw_ref import NEG, SWParams, SWResult

LANES = 128
POS_STRIDE = 4096  # bestpos = diagonal * POS_STRIDE + row;
                   # supports read buckets to 4096 rows and ~500k diagonals
                   # within int32


@dataclasses.dataclass(frozen=True)
class SWBucket:
    """Static shapes for one compiled variant."""
    max_read_len: int = 160
    max_win_len: int = 416


@functools.partial(jax.jit, static_argnames=("params", "R", "W"))
def _sw_device_fused(blob, *, params: SWParams, R: int, W: int):
    """Single-transfer entry: one uint8 blob [reads; windows; len bytes].

    The four inputs share one buffer, so a batched-SW call is ONE transfer.
    Rows R+W..R+W+3 carry read/window lengths as little-endian byte pairs
    (lengths < 65536).
    """
    read = blob[:R].astype(jnp.int32)
    win = blob[R:R + W].astype(jnp.int32)
    lens = blob[R + W:R + W + 4].astype(jnp.int32)
    rlen = (lens[0] | (lens[1] << 8))[None, :]
    wlen = (lens[2] | (lens[3] << 8))[None, :]
    return _sw_scan_core(read, rlen, win, wlen, params=params, R=R, W=W)


def _sw_score_lanes(read, rlen, win, wlen, *, params: SWParams, R: int,
                    W: int, impl: str):
    """Best local score per lane of time-major (R, B)/(W, B) int32 tiles
    with (1, B) lengths -> (B,) int32."""
    if impl == dispatch.CUDA:
        from . import gpu_kernels
        B = read.shape[1]
        return gpu_kernels.sw_score(
            read.T, rlen.reshape(B), win.T, wlen.reshape(B),
            match=params.match, mismatch=params.mismatch,
            gap_open=params.gap_open, gap_ext=params.gap_ext)
    _, best, _ = _sw_scan_core(read, rlen, win, wlen, params=params,
                               R=R, W=W)
    return best[0]


def _sw_scan_core(read, rlen, win, wlen, *, params: SWParams, R: int, W: int):
    """Portable lax.scan version with identical semantics."""
    i32 = jnp.int32
    B = read.shape[1]
    go, ge = params.gap_open + params.gap_ext, params.gap_ext
    rvec = jnp.arange(R, dtype=i32).reshape(R, 1)
    zero_row = jnp.zeros((1, B), i32)
    neg_row = jnp.full((1, B), NEG, i32)

    def shift(x, fill):
        return jnp.concatenate([fill, x[:-1]], axis=0)

    def step(carry, d):
        h1, h2, e1, f1, wind, best, bestpos = carry
        new_row = jax.lax.dynamic_slice(win, (jnp.clip(d - 1, 0, W - 1), 0),
                                        (1, B))
        wind = shift(wind, new_row)
        jv = d - rvec
        e_open = h1 - go
        e_ext = e1 - ge
        e_new = jnp.maximum(e_open, e_ext)
        eext = (e_ext > e_open).astype(i32)
        h1s = shift(h1, zero_row)
        f_open = h1s - go
        f_ext = shift(f1, neg_row) - ge
        f_new = jnp.maximum(f_open, f_ext)
        fext = (f_ext > f_open).astype(i32)
        sub = jnp.where(read == wind, i32(params.match),
                        i32(-params.mismatch))
        diag = shift(h2, zero_row) + sub
        h_new = jnp.maximum(jnp.maximum(0, diag), jnp.maximum(e_new, f_new))
        valid = (jv >= 1) & (jv <= wlen) & (rvec < rlen)
        h_new = jnp.where(valid, h_new, 0)
        e_new = jnp.where(valid, e_new, NEG)
        f_new = jnp.where(valid, f_new, NEG)
        hdir = jnp.where(
            h_new == 0, 0,
            jnp.where(h_new == diag, 1, jnp.where(h_new == e_new, 2, 3)))
        ptr = (hdir | (eext << 2) | (fext << 3)).astype(jnp.int8)
        m = jnp.max(h_new, axis=0, keepdims=True)
        rowarg = jnp.min(
            jnp.where(h_new == m, rvec, jnp.full_like(rvec, 1 << 30)),
            axis=0, keepdims=True)
        upd = m > best
        best = jnp.where(upd, m, best)
        bestpos = jnp.where(upd, d * POS_STRIDE + rowarg, bestpos)
        return (h_new, h1, e_new, f_new, wind, best, bestpos), ptr

    init = (jnp.zeros((R, B), i32), jnp.zeros((R, B), i32),
            jnp.full((R, B), NEG, i32), jnp.full((R, B), NEG, i32),
            jnp.zeros((R, B), i32), jnp.zeros((1, B), i32),
            jnp.zeros((1, B), i32))
    (h1, h2, e1, f1, wind, best, bestpos), ptrs = jax.lax.scan(
        step, init, jnp.arange(R + W))
    return ptrs, best, bestpos


# ---------------------------------------------------------------------------
# device-resident genome + on-device lane assembly
# ---------------------------------------------------------------------------

def device_genome(genome_codes: np.ndarray) -> jnp.ndarray:
    """Ship the reference genome to device memory once (int8); windows
    are gathered from it on device thereafter."""
    return jnp.asarray(np.asarray(genome_codes, np.int8))


@jax.jit
def _transpose_dev(x):
    return x.T


def device_reads(reads: np.ndarray) -> jnp.ndarray:
    """Ship a (NR, R) batch of padded read codes once, time-major int8.

    The lane-count axis is padded to a multiple of 128 for layout.  The
    host array is copied contiguous; the transpose happens on device."""
    NR, R = reads.shape
    NRp = _round_up(max(NR, 1), 128)
    out = np.full((NRp, R), 4, np.int8)
    out[:NR] = reads
    return _transpose_dev(jnp.asarray(out))


def _lane_inputs(reads8, read_idx, is_rev, rlen, genome, starts, W):
    """On-device assembly of per-lane (read, window) int32 tiles.

    reads8: (R, NR) int8 resident reads; read_idx/is_rev/rlen/starts are
    (1, B) lane metadata.  Reverse-strand lanes get the reverse complement
    (row remap + 3-code), so the host never re-ships read bytes per
    candidate."""
    R = reads8.shape[0]
    B = read_idx.shape[1]
    read = jnp.take(reads8, read_idx[0], axis=1).astype(jnp.int32)  # (R, B)
    rvec = jax.lax.broadcasted_iota(jnp.int32, (R, B), 0)
    ridx = jnp.where(is_rev > 0, rlen - 1 - rvec, rvec)
    gathered = jnp.take_along_axis(read, jnp.clip(ridx, 0, R - 1), axis=0)
    comp = jnp.where(gathered < 4, 3 - gathered, gathered)
    read = jnp.where(rvec < rlen,
                     jnp.where(is_rev > 0, comp, gathered), 4)

    G = genome.shape[0]
    wvec = jax.lax.broadcasted_iota(jnp.int32, (W, B), 0)
    widx = starts + wvec
    valid = jnp.logical_and(widx >= 0, widx < G)
    win = jnp.take(genome, jnp.clip(widx, 0, G - 1), axis=0).astype(jnp.int32)
    win = jnp.where(valid, win, 5)     # 5 matches no base code
    return read, win


# lane metadata rows in the packed (5, B) int32 array (one transfer)
_META_READ_IDX, _META_IS_REV, _META_RLEN, _META_START, _META_WLEN = range(5)


@functools.partial(jax.jit, static_argnames=("params", "bucket", "impl"))
def _sw_gather_score(reads8, meta, genome, *, params: SWParams,
                     bucket: SWBucket, impl: str):
    rlen = meta[_META_RLEN:_META_RLEN + 1]
    wlen = meta[_META_WLEN:_META_WLEN + 1]
    read, win = _lane_inputs(
        reads8, meta[_META_READ_IDX:_META_READ_IDX + 1],
        meta[_META_IS_REV:_META_IS_REV + 1], rlen, genome,
        meta[_META_START:_META_START + 1], bucket.max_win_len)
    return _sw_score_lanes(read, rlen, win, wlen, params=params,
                           R=bucket.max_read_len, W=bucket.max_win_len,
                           impl=impl)


@functools.partial(jax.jit, static_argnames=("params", "bucket", "max_steps"))
def _sw_gather_full(reads8, meta, genome, *, params: SWParams,
                    bucket: SWBucket, max_steps: int):
    """Full alignment of gathered lanes: wavefront + on-device traceback.

    One dispatch; the (D, R, B) pointer array never leaves the device.  Returns the
    packed op stream + path coordinates."""
    rlen = meta[_META_RLEN:_META_RLEN + 1]
    wlen = meta[_META_WLEN:_META_WLEN + 1]
    read, win = _lane_inputs(
        reads8, meta[_META_READ_IDX:_META_READ_IDX + 1],
        meta[_META_IS_REV:_META_IS_REV + 1], rlen, genome,
        meta[_META_START:_META_START + 1], bucket.max_win_len)
    ptrs, best, bestpos = _sw_scan_core(
        read, rlen, win, wlen, params=params,
        R=bucket.max_read_len, W=bucket.max_win_len)
    # one fused uint8 buffer: op stream + coords + scores (one d2h)
    return _traceback_core(ptrs, best[0], bestpos[0], max_steps=max_steps)


def _pack_meta(read_idx, is_rev, read_lens, win_starts, win_lens,
               Bp: int) -> np.ndarray:
    B = len(read_idx)
    meta = np.zeros((5, Bp), np.int32)
    meta[_META_READ_IDX, :B] = read_idx
    meta[_META_IS_REV, :B] = np.asarray(is_rev, np.int32)
    meta[_META_RLEN, :B] = read_lens
    meta[_META_START, :B] = win_starts
    meta[_META_WLEN, :B] = win_lens
    return meta


def _pow2_lanes(B: int) -> int:
    Bp = LANES
    while Bp < B:
        Bp *= 2
    return Bp


def sw_score_gather(reads8_dev, read_idx, is_rev, read_lens, genome_dev,
                    win_starts, win_lens, params: SWParams = SWParams(),
                    bucket: SWBucket | None = None) -> np.ndarray:
    """Score-only SW over candidate lanes assembled on device.

    reads8_dev/genome_dev come from device_reads()/device_genome(); the
    host ships only the (5, B) lane metadata.  Returns the best local
    score per lane."""
    bucket = bucket or SWBucket()
    B = len(read_idx)
    if B == 0:
        return np.zeros(0, np.int32)
    Bp = _pow2_lanes(B)
    meta = jnp.asarray(_pack_meta(read_idx, is_rev, read_lens, win_starts,
                                  win_lens, Bp))
    best = _sw_gather_score(reads8_dev, meta, genome_dev, params=params,
                            bucket=bucket, impl=dispatch.choose("sw_score"))
    return np.asarray(best)[:B]


def sw_extend_gather(reads8_dev, read_idx, is_rev, read_lens, genome_dev,
                     win_starts, win_lens, params: SWParams = SWParams(),
                     bucket: SWBucket | None = None) -> list[SWResult]:
    """Full SW (CIGAR traceback) over candidate lanes assembled on device."""
    bucket = bucket or SWBucket()
    B = len(read_idx)
    if B == 0:
        return []
    if B > MAX_LANES_PER_CALL:
        out: list[SWResult] = []
        for s in range(0, B, MAX_LANES_PER_CALL):
            e = s + MAX_LANES_PER_CALL
            out.extend(sw_extend_gather(
                reads8_dev, read_idx[s:e], is_rev[s:e], read_lens[s:e],
                genome_dev, win_starts[s:e], win_lens[s:e], params, bucket))
        return out
    Bp = _pow2_lanes(B)
    meta_np = _pack_meta(read_idx, is_rev, read_lens, win_starts, win_lens,
                         Bp)
    max_steps = _traceback_steps_bound(
        int(np.max(meta_np[_META_RLEN])), int(np.max(meta_np[_META_WLEN])),
        params, bucket)
    fused = np.asarray(_sw_gather_full(
        reads8_dev, jnp.asarray(meta_np), genome_dev,
        params=params, bucket=bucket, max_steps=max_steps))
    packed_h, coords_h, best_h = _decode_traceback(fused, max_steps, B)
    return _results_from_packed(packed_h, max_steps, coords_h, best_h,
                                np.asarray(read_lens))


@dataclasses.dataclass(frozen=True)
class PairPolicy:
    """Static pair-selection parameters for the fused device path
    (mirrors AlignerParams' pairing fields)."""
    max_candidates: int = 4
    window_pad: int = 32
    min_insert: int = 0
    max_insert: int = 1000
    unpaired_penalty: int = 17


@functools.partial(jax.jit, static_argnames=("params", "bucket", "pair",
                                             "max_steps", "nr", "impl"))
def _sw_pair_fused(reads8, meta_j, flat_idx, genome, *, params: SWParams,
                   bucket: SWBucket, pair: PairPolicy, max_steps: int,
                   nr: int, impl: str):
    """ONE device dispatch for the whole pair-alignment batch:

      score-only SW over every candidate job → scatter to a dense
      (reads, K) candidate grid → best/second per read → all-combo
      FR-orientation pair selection → winner gather → full SW +
      traceback on the winners.

    The host previously ran the pairing between two separate dispatches,
    paying a device round-trip for the score sync before it could launch
    the extension; fusing moves the
    (cheap, K≤4-way unrolled) selection math on device so the batch costs
    ONE round-trip.  Everything returns in one uint8 buffer: the fused
    traceback block (op stream + coords + scores) followed by 12 rows
    encoding (winner_job, sub_score, best_score) as LE int32 bytes.

    Selection semantics replicate the round-4 host path bit-for-bit
    (ties: higher score, then smaller window position, then candidate
    rank; combo ties keep the first (k1, k2) in row-major order), which
    tests assert against the reference numpy implementation.
    """
    i32 = jnp.int32
    K = pair.max_candidates
    B1 = nr // 2
    W = bucket.max_win_len
    Jp = meta_j.shape[1]

    rlen = meta_j[_META_RLEN:_META_RLEN + 1]
    wlen = meta_j[_META_WLEN:_META_WLEN + 1]
    read, win = _lane_inputs(
        reads8, meta_j[_META_READ_IDX:_META_READ_IDX + 1],
        meta_j[_META_IS_REV:_META_IS_REV + 1], rlen, genome,
        meta_j[_META_START:_META_START + 1], W)
    score = _sw_score_lanes(read, rlen, win, wlen, params=params,
                            R=bucket.max_read_len, W=W, impl=impl)  # (Jp,)
    start = meta_j[_META_START]
    jpos = start + jnp.minimum(i32(pair.window_pad), start)
    valid = score > 0

    def scatter(vals, fill):
        return jnp.full(nr * K, fill, i32).at[flat_idx].set(
            vals.astype(i32), mode="drop").reshape(nr, K)

    d_score = scatter(jnp.where(valid, score, 0), 0)
    d_job = scatter(jnp.where(valid, jnp.arange(Jp, dtype=i32), -1), -1)
    d_pos = scatter(jpos, 0)
    d_rev = scatter(meta_j[_META_IS_REV], 0)
    d_rlen = scatter(meta_j[_META_RLEN], 0)

    # best + second-best per read by (score desc, pos asc, rank asc)
    bs = jnp.zeros(nr, i32)
    bp = jnp.zeros(nr, i32)
    bjob = jnp.full(nr, -1, i32)
    bk = jnp.full(nr, -1, i32)
    for k in range(K):
        s, p_, j_ = d_score[:, k], d_pos[:, k], d_job[:, k]
        ok = j_ >= 0
        better = ok & ((bjob < 0) | (s > bs) | ((s == bs) & (p_ < bp)))
        bs = jnp.where(better, s, bs)
        bp = jnp.where(better, p_, bp)
        bjob = jnp.where(better, j_, bjob)
        bk = jnp.where(better, k, bk)
    ss = jnp.zeros(nr, i32)
    sp = jnp.zeros(nr, i32)
    sv = jnp.zeros(nr, bool)
    for k in range(K):
        s, p_, j_ = d_score[:, k], d_pos[:, k], d_job[:, k]
        ok = (j_ >= 0) & (bk != k)
        better = ok & (~sv | (s > ss) | ((s == ss) & (p_ < sp)))
        ss = jnp.where(better, s, ss)
        sp = jnp.where(better, p_, sp)
        sv = sv | better
    sub_of = jnp.where(sv, ss, 0)

    # all K×K combos per fragment: FR orientation within insert bounds
    s1, s2 = d_score[:B1], d_score[B1:]
    rev1, rev2 = d_rev[:B1], d_rev[B1:]
    pos1, pos2 = d_pos[:B1], d_pos[B1:]
    rl1, rl2 = d_rlen[:B1], d_rlen[B1:]
    jbest = jnp.full(B1, -1, i32)
    w1 = jnp.full(B1, -1, i32)
    w2 = jnp.full(B1, -1, i32)
    for k1 in range(K):
        for k2 in range(K):
            a_fwd = rev1[:, k1] == 0
            span = jnp.where(
                a_fwd, (pos2[:, k2] + rl2[:, k2]) - pos1[:, k1],
                (pos1[:, k1] + rl1[:, k1]) - pos2[:, k2])
            ok = ((rev1[:, k1] != rev2[:, k2])
                  & (span >= pair.min_insert) & (span <= pair.max_insert)
                  & (s1[:, k1] > 0) & (s2[:, k2] > 0))
            cand = jnp.where(ok, s1[:, k1] + s2[:, k2], -1)
            better = cand > jbest
            jbest = jnp.where(better, cand, jbest)
            w1 = jnp.where(better, d_job[:B1, k1], w1)
            w2 = jnp.where(better, d_job[B1:, k2], w2)
    solo = bs[:B1] + bs[B1:] - i32(pair.unpaired_penalty)
    use_pair = (jbest > 0) & (jbest >= solo)
    winner_job = jnp.where(jnp.concatenate([use_pair, use_pair]),
                           jnp.concatenate([w1, w2]), bjob)

    # winner full SW + on-device traceback
    wj = jnp.clip(winner_job, 0)
    bad = winner_job < 0
    rlen_w = jnp.where(bad, 0, meta_j[_META_RLEN][wj])[None, :]
    wlen_w = jnp.where(bad, 0, meta_j[_META_WLEN][wj])[None, :]
    read_w, win_w = _lane_inputs(
        reads8, meta_j[_META_READ_IDX][wj][None, :],
        meta_j[_META_IS_REV][wj][None, :], rlen_w, genome,
        meta_j[_META_START][wj][None, :], W)
    ptrs, best, bestpos = _sw_scan_core(
        read_w, rlen_w, win_w, wlen_w, params=params,
        R=bucket.max_read_len, W=W)
    fused = _traceback_core(ptrs, best[0], bestpos[0], max_steps=max_steps)

    aux = jnp.stack([winner_job, sub_of, bs])          # (3, nr)
    abytes = jnp.concatenate(
        [((aux >> (8 * t)) & 0xFF).astype(jnp.uint8) for t in range(4)],
        axis=0)                                        # (12, nr)
    return jnp.concatenate([fused, abytes], axis=0)


@functools.partial(jax.jit, static_argnames=("params", "bucket",
                                             "max_steps"))
def _sw_winget_full(reads8, meta, genome, *, params: SWParams,
                    bucket: SWBucket, max_steps: int):
    """Full SW where lane READS ship as a matrix but WINDOWS gather on
    device from the resident genome (the long-read chunk path: windows
    are genome slices, so no window bytes are shipped)."""
    W = bucket.max_win_len
    rlen = meta[_META_RLEN:_META_RLEN + 1]
    wlen = meta[_META_WLEN:_META_WLEN + 1]
    starts = meta[_META_START:_META_START + 1]
    read = reads8.astype(jnp.int32)
    G = genome.shape[0]
    B = read.shape[1]
    wvec = jax.lax.broadcasted_iota(jnp.int32, (W, B), 0)
    widx = starts + wvec
    valid = jnp.logical_and(widx >= 0, widx < G)
    win = jnp.take(genome, jnp.clip(widx, 0, G - 1),
                   axis=0).astype(jnp.int32)
    win = jnp.where(valid, win, 5)
    ptrs, best, bestpos = _sw_scan_core(
        read, rlen, win, wlen, params=params, R=bucket.max_read_len, W=W)
    return _traceback_core(ptrs, best[0], bestpos[0], max_steps=max_steps)


def sw_extend_win_dispatch(reads: np.ndarray, read_lens: np.ndarray,
                           genome_dev, win_starts: np.ndarray,
                           win_lens: np.ndarray,
                           params: SWParams, bucket: SWBucket):
    """Async window-gather extension: reads ship, windows stay on device.
    Returns a handle for ``sw_extend_collect``."""
    B = reads.shape[0]
    if B > MAX_LANES_PER_CALL:
        handles = []
        for s in range(0, B, MAX_LANES_PER_CALL):
            e = s + MAX_LANES_PER_CALL
            handles.append(sw_extend_win_dispatch(
                reads[s:e], read_lens[s:e], genome_dev, win_starts[s:e],
                win_lens[s:e], params, bucket))
        return ("multi", handles)
    Bp = _pow2_lanes(B)
    R = bucket.max_read_len
    pad = np.full((Bp, R), 4, np.int8)
    pad[:B, :reads.shape[1]] = reads
    meta = _pack_meta(np.zeros(B, np.int32), np.zeros(B, np.int32),
                      read_lens, win_starts, win_lens, Bp)
    max_steps = _traceback_steps_bound(
        int(np.max(read_lens)) if B else 0,
        int(np.max(win_lens)) if B else 0, params, bucket)
    out_dev = _sw_winget_full(
        _transpose_dev(jnp.asarray(pad)), jnp.asarray(meta), genome_dev,
        params=params, bucket=bucket, max_steps=max_steps)
    try:
        out_dev.copy_to_host_async()
    except AttributeError:
        pass

    def collect():
        out = np.asarray(out_dev)
        packed_h, coords_h, best_h = _decode_traceback(out, max_steps, B)
        return _results_from_packed(packed_h, max_steps, coords_h,
                                    best_h, np.asarray(read_lens))

    def collect_arrays():
        """Array form: (ops, lens, nc, coords, best) — no SWResult
        objects (the long-read assembler consumes rows directly)."""
        out = np.asarray(out_dev)
        packed_h, coords_h, best_h = _decode_traceback(out, max_steps, B)
        from ..io import native_ext
        i_f, j_f, bi, bj = coords_h
        nat = native_ext.ops_rle_batch(packed_h, max_steps, i_f, bi,
                                       best_h,
                                       np.asarray(read_lens, np.int32))
        if nat is None:
            res = _results_from_packed(packed_h, max_steps, coords_h,
                                       best_h, np.asarray(read_lens))
            mo = 160
            ops_a = np.zeros((B, mo), np.int32)
            lens_a = np.zeros((B, mo), np.int32)
            nc = np.zeros(B, np.int32)
            for b, r in enumerate(res):
                n = min(len(r.cigar), mo)
                nc[b] = n
                for t in range(n):
                    ops_a[b, t], lens_a[b, t] = r.cigar[t]
            return ops_a, lens_a, nc, coords_h, best_h
        ops_a, lens_a, nc = nat
        return ops_a, lens_a, nc, coords_h, best_h
    return ("one", collect, collect_arrays)


def sw_pair_dispatch(reads8_dev, j_read, j_rev, j_rlen, genome_dev,
                     j_start, j_wlen, slice_of, read_lens,
                     params: SWParams, bucket: SWBucket, pair: PairPolicy):
    """Async half of the fused pair path: enqueues the device work (XLA
    dispatch is asynchronous) and returns an opaque handle.  The caller
    overlaps host work (next batch's seeding, previous batch's emission)
    with the device computing this batch, then syncs via
    ``sw_pair_collect``."""
    NR = len(read_lens)
    B1 = NR // 2
    NRp = _pow2_lanes(NR)
    H = NRp // 2           # mate2 lanes sit at [H, H+B1) after padding,
    # so the device kernel's half-split pairing (lane f ↔ lane H+f)
    # matches the fragment structure even when NR < NRp
    J = len(j_read)
    Jp = _pow2_lanes(max(J, 1))
    K = pair.max_candidates
    j_read = np.asarray(j_read, np.int64)
    meta_np = _pack_meta(j_read, j_rev, j_rlen, j_start, j_wlen, Jp)
    ranks = np.arange(J) - slice_of[j_read]
    rid = np.where(j_read < B1, j_read, j_read + (H - B1))
    flat = np.full(Jp, NRp * K, np.int32)            # pad rows drop
    flat[:J] = rid * K + ranks
    max_steps = _traceback_steps_bound(
        int(np.max(read_lens)), int(np.max(j_wlen)) if J else 0,
        params, bucket)
    out_dev = _sw_pair_fused(
        reads8_dev, jnp.asarray(meta_np), jnp.asarray(flat), genome_dev,
        params=params, bucket=bucket, pair=pair, max_steps=max_steps,
        nr=NRp, impl=dispatch.choose("sw_score"))
    # enqueue the D2H copy now: it starts the moment the kernel finishes,
    # overlapping the transfer with the host work the caller does before
    # sw_pair_collect
    try:
        out_dev.copy_to_host_async()
    except AttributeError:
        pass
    return (out_dev, max_steps, NR, B1, H, np.asarray(read_lens))


def sw_pair_collect(handle):
    """Sync half of the fused pair path → array-native results.

    Returns ``(ops, lens, nc, coords, best, winner_job, sub_of,
    best_score)``: per-READ-lane CIGAR arrays ((NR, max_ops) int32 ×2 +
    (NR,) counts), the (4, NR) path coordinates (read_start, ref_start,
    read_end, ref_end), per-lane best scores, the winning job row
    (-1 = unmapped), the mapq sub-score, and the best single-end score
    (mate-rescue anchoring).  No per-lane python objects."""
    out_dev, max_steps, NR, B1, H, read_lens = handle
    out = np.asarray(out_dev)
    lanes = np.concatenate([np.arange(B1), H + np.arange(B1)])
    S4r = ((max_steps + 3) // 4 * 4) // 4
    packed_h, coords_h, best_h = _decode_traceback(
        out[:S4r + 12, lanes], max_steps, NR)
    aux = out[S4r + 12:, lanes].astype(np.int32)
    winner_job = (aux[0] | (aux[3] << 8) | (aux[6] << 16) | (aux[9] << 24))
    sub_of = (aux[1] | (aux[4] << 8) | (aux[7] << 16) | (aux[10] << 24))
    best_score = (aux[2] | (aux[5] << 8) | (aux[8] << 16)
                  | (aux[11] << 24))
    i_f, j_f, bi, bj = coords_h
    from ..io import native_ext
    nat = native_ext.ops_rle_batch(packed_h, max_steps, i_f, bi, best_h,
                                   np.asarray(read_lens, np.int32))
    if nat is not None:
        ops_a, lens_a, nc = nat
    else:
        results = _results_from_packed(packed_h, max_steps, coords_h,
                                       best_h, read_lens)
        max_ops = 160
        ops_a = np.zeros((NR, max_ops), np.int32)
        lens_a = np.zeros((NR, max_ops), np.int32)
        nc = np.zeros(NR, np.int32)
        for b, r in enumerate(results):
            n = min(len(r.cigar), max_ops)
            nc[b] = n
            for t in range(n):
                ops_a[b, t], lens_a[b, t] = r.cigar[t]
    return ops_a, lens_a, nc, coords_h, best_h, winner_job, sub_of, \
        best_score


@functools.partial(jax.jit, static_argnames=("max_steps",))
def _traceback_device(ptrs, best, bestpos, *, max_steps: int):
    return _traceback_core(ptrs, best, bestpos, max_steps=max_steps)


def _traceback_core(ptrs, best, bestpos, *, max_steps: int):
    """Vectorized traceback on device — the pointer array never leaves
    the device.

    Walks all lanes in lockstep (one cell per step, ≤ R+W steps), emitting
    per-step op codes (-1 = none, else SAM op M/I/D).  The host only
    receives the op stream — packed 4 ops/byte, (max_steps/4, B) — plus
    final coordinates: a few hundred KB instead of the multi-GB pointer
    array.
    """
    D, R, B = ptrs.shape
    flat = ptrs.reshape(D * R, B)
    d_prog = bestpos // POS_STRIDE
    r = bestpos % POS_STRIDE
    bi = r + 1
    bj = d_prog - r
    phase0 = jnp.zeros(B, jnp.int32)           # 0=H, 1=E(D-run), 2=F(I-run)
    active0 = best > 0

    def step_math(i, j, phase, active):
        idx = jnp.clip((i + j - 1) * R + (i - 1), 0, D * R - 1)
        byte = jnp.take_along_axis(
            flat, idx[None, :].astype(jnp.int32), axis=0)[0].astype(
            jnp.int32)
        hdir = byte & 3
        eext = (byte >> 2) & 1
        fext = (byte >> 3) & 1
        act = active & (i > 0) & (j > 0)
        is_h = phase == 0
        stop = act & is_h & (hdir == 0)
        do_m = act & is_h & (hdir == 1)
        in_e = act & ((phase == 1) | (is_h & (hdir == 2)))
        in_f = act & ((phase == 2) | (is_h & (hdir == 3))) & ~in_e
        moving = act & ~stop
        op = jnp.where(do_m, 0, jnp.where(in_e, 2, jnp.where(in_f, 1, -1)))
        op = jnp.where(moving, op, -1)
        di = jnp.where(moving & (do_m | in_f), 1, 0)
        dj = jnp.where(moving & (do_m | in_e), 1, 0)
        phase = jnp.where(in_e & (eext == 1), 1,
                          jnp.where(in_f & (fext == 1), 2, 0))
        return i - di, j - dj, phase, moving, op

    # while_loop with an all-lanes-done early exit: the walk length is
    # the LONGEST path in the batch (~read_len + a few indels, typically
    # well under half of max_steps), and every step is a serial
    # cross-lane gather from device memory
    ops_buf0 = jnp.full((max_steps, B), -1, jnp.int32)

    def cond(carry):
        t, i, j, phase, active, _ = carry
        return (t < max_steps) & jnp.any(active)

    def body(carry):
        t, i, j, phase, active, ops_buf = carry
        i, j, phase, moving, op = step_math(i, j, phase, active)
        ops_buf = jax.lax.dynamic_update_slice(
            ops_buf, op[None, :], (t, 0))
        return (t + 1, i, j, phase, moving, ops_buf)

    _, i_f, j_f, _, _, ops = jax.lax.while_loop(
        cond, body, (jnp.int32(0), bi, bj, phase0, active0, ops_buf0))
    # pack 4 ops/byte (each op in -1..2 → biased 0..3): 4× fewer bytes
    S4 = (max_steps + 3) // 4 * 4
    ops2 = jnp.pad((ops + 1).astype(jnp.uint8), ((0, S4 - max_steps), (0, 0)))
    ops2 = ops2.reshape(S4 // 4, 4, B)
    packed = (ops2[:, 0] | (ops2[:, 1] << 2) | (ops2[:, 2] << 4)
              | (ops2[:, 3] << 6))
    # everything rides back in ONE uint8 array: op stream, then path
    # coordinates
    # (read_start, ref_start, read_end, ref_end) as LE byte pairs, then
    # the best score as 4 LE bytes
    coords = jnp.stack([i_f, j_f, bi, bj]).astype(jnp.int32)
    clo = (coords & 0xFF).astype(jnp.uint8)
    chi = ((coords >> 8) & 0xFF).astype(jnp.uint8)
    cbytes = jnp.concatenate([clo, chi], axis=0)      # (8, B)
    b32 = best.astype(jnp.int32)
    bbytes = jnp.stack([b32 & 0xFF, (b32 >> 8) & 0xFF,
                        (b32 >> 16) & 0xFF,
                        (b32 >> 24) & 0xFF]).astype(jnp.uint8)
    return jnp.concatenate([packed, cbytes, bbytes], axis=0)


def _decode_traceback(fused_h: np.ndarray, max_steps: int, B: int
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split the fused traceback buffer (host copy) back into the packed
    op stream, (4, B) path coordinates, and per-lane best scores."""
    S4r = ((max_steps + 3) // 4 * 4) // 4
    packed_h = fused_h[:S4r, :B]
    cb = fused_h[S4r:S4r + 8, :B].astype(np.int32)
    coords_h = cb[:4] | (cb[4:] << 8)
    bb = fused_h[S4r + 8:S4r + 12, :B].astype(np.int32)
    best_h = bb[0] | (bb[1] << 8) | (bb[2] << 16) | (bb[3] << 24)
    return packed_h, coords_h, best_h


def _results_from_packed(packed: np.ndarray, max_steps: int,
                         coords: np.ndarray, best: np.ndarray,
                         read_lens: np.ndarray) -> list[SWResult]:
    """Packed op streams + (4, B) coords → SWResults (native RLE when the
    fgio extension is built, python fallback otherwise)."""
    i_f, j_f, bi, bj = coords
    from ..io import native_ext
    nat = native_ext.ops_rle_batch(packed, max_steps, i_f, bi, best,
                                   np.asarray(read_lens, np.int32))
    if nat is not None:
        ops_a, lens_a, nc = nat
        results: list[SWResult] = []
        for b in range(len(read_lens)):
            n = int(nc[b])
            cigar = list(zip(ops_a[b, :n].tolist(), lens_a[b, :n].tolist()))
            if best[b] > 0:
                results.append(SWResult(
                    int(best[b]), int(i_f[b]), int(bi[b]), int(j_f[b]),
                    int(bj[b]), cigar))
            else:
                results.append(SWResult(0, 0, 0, 0, 0, cigar))
        return results
    ops = _unpack_ops(packed, max_steps)
    return _results_from_device_traceback(ops, i_f, j_f, bi, bj, best,
                                          read_lens)


def _unpack_ops(packed: np.ndarray, max_steps: int) -> np.ndarray:
    """(S/4, B) packed bytes → (max_steps, B) int8 ops in -1..2."""
    S4, B = packed.shape
    out = np.empty((S4 * 4, B), np.int8)
    for t in range(4):
        out[t::4] = ((packed >> (2 * t)) & 3).astype(np.int8) - 1
    return out[:max_steps]


def _results_from_device_traceback(ops: np.ndarray, i_f, j_f, bi, bj,
                                   best, read_lens) -> list[SWResult]:
    """Host side: reverse + run-length-encode the per-lane op streams."""
    B = ops.shape[1]
    results: list[SWResult] = []
    for b in range(B):
        score = int(best[b])
        rl = int(read_lens[b])
        if score <= 0:
            results.append(SWResult(
                0, 0, 0, 0, 0, [(CIGAR_S, rl)] if rl else []))
            continue
        seq = ops[:, b]
        seq = seq[seq >= 0][::-1]
        cigar: Cigar = []
        if i_f[b] > 0:
            cigar.append((CIGAR_S, int(i_f[b])))
        if len(seq):
            breaks = np.nonzero(np.diff(seq))[0]
            starts = np.concatenate([[0], breaks + 1])
            ends = np.concatenate([breaks + 1, [len(seq)]])
            for s, e in zip(starts, ends):
                cigar.append((int(seq[s]), int(e - s)))
        if rl - int(bi[b]) > 0:
            cigar.append((CIGAR_S, rl - int(bi[b])))
        results.append(SWResult(score, int(i_f[b]), int(bi[b]),
                                int(j_f[b]), int(bj[b]), cigar))
    return results


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _traceback_steps_bound(rlen_max: int, wlen_max: int, params: SWParams,
                           bucket: SWBucket) -> int:
    """Provable bound on the device traceback's step count.

    Path steps = #M + #I + #D with #M + #I ≤ rlen.  A positive-score
    local path has match·rlen − (go + ge·#gapbases) ≥ score > 0, so
    #D < (match·rlen − go) / ge — for 150 bp reads at bwa scoring this
    caps the walk at ~294 steps instead of rlen + wlen = 564 (each step is
    a serial per-lane gather).  Rounded to 128 to bound compile
    variants."""
    d_max = max(0, (rlen_max * params.match - params.gap_open
                    - params.gap_ext) // params.gap_ext)
    need = min(rlen_max + wlen_max, rlen_max + d_max) + 8
    return min(bucket.max_read_len + bucket.max_win_len,
               _round_up(need, 128))


# Bounds the on-device pointer array (~0.8 GB int8 at 8192 lanes for the
# aligner's 160×416 bucket — transient within one dispatch).  8192 lets a
# full 4096-pair batch's winners extend in ONE call: each extra call costs
# a device round-trip.
MAX_LANES_PER_CALL = 8192


def sw_extend_batch(reads: np.ndarray, read_lens: np.ndarray,
                    windows: np.ndarray, win_lens: np.ndarray,
                    params: SWParams = SWParams(),
                    bucket: SWBucket | None = None) -> list[SWResult]:
    """Align each read against its reference window; returns per-pair
    score/spans/CIGAR (soft clips included)."""
    return sw_extend_collect(sw_extend_dispatch(
        reads, read_lens, windows, win_lens, params, bucket))


def sw_extend_dispatch(reads: np.ndarray, read_lens: np.ndarray,
                       windows: np.ndarray, win_lens: np.ndarray,
                       params: SWParams = SWParams(),
                       bucket: SWBucket | None = None):
    """Async half of sw_extend_batch: enqueues the device work (XLA
    dispatch is asynchronous) and returns an opaque handle —
    ``sw_extend_collect(handle)`` blocks on the d2h sync and walks the
    results.  Callers overlap host work for the NEXT sub-batch with the
    device computing THIS one (the long-read aligner's pipeline)."""
    bucket = bucket or SWBucket()
    if reads.shape[0] > MAX_LANES_PER_CALL:
        handles = []
        for s in range(0, reads.shape[0], MAX_LANES_PER_CALL):
            e = s + MAX_LANES_PER_CALL
            handles.append(sw_extend_dispatch(
                reads[s:e], read_lens[s:e], windows[s:e], win_lens[s:e],
                params, bucket))
        return ("multi", handles)
    return ("one", _sw_extend_dispatch_one(reads, read_lens, windows,
                                           win_lens, params, bucket))


def sw_extend_collect(handle) -> list[SWResult]:
    kind, payload = handle[0], handle[1]
    if kind == "multi":
        out: list[SWResult] = []
        for h in payload:
            out.extend(sw_extend_collect(h))
        return out
    return payload() if callable(payload) else payload


def sw_extend_collect_arrays(handle):
    """Array form of sw_extend_collect for handles that support it
    (sw_extend_win_dispatch): (ops, lens, nc, coords, best), rows
    concatenated across sub-calls."""
    kind = handle[0]
    if kind == "multi":
        parts = [sw_extend_collect_arrays(h) for h in handle[1]]
        mo = max(p[0].shape[1] for p in parts)

        def padw(a):
            if a.shape[1] == mo:
                return a
            out = np.zeros((a.shape[0], mo), a.dtype)
            out[:, :a.shape[1]] = a
            return out
        return (np.concatenate([padw(p[0]) for p in parts]),
                np.concatenate([padw(p[1]) for p in parts]),
                np.concatenate([p[2] for p in parts]),
                np.concatenate([p[3] for p in parts], axis=1),
                np.concatenate([p[4] for p in parts]))
    return handle[2]()


def _sw_extend_dispatch_one(reads, read_lens, windows, win_lens,
                            params, bucket):
    B, Rin = reads.shape
    Win = windows.shape[1]
    if Rin > bucket.max_read_len or Win > bucket.max_win_len:
        raise ValueError("input exceeds SW bucket shape")
    R, W = bucket.max_read_len, bucket.max_win_len
    # power-of-two lane bucket: bounds compile variants to ~log2 shapes
    Bp = LANES
    while Bp < B:
        Bp *= 2

    # one fused, contiguous uint8 blob = ONE host→device transfer
    blob = np.empty((R + W + 4, Bp), np.uint8)
    blob[:R] = 4
    blob[:reads.shape[1], :B] = reads.T
    blob[R:R + W] = 5                      # 5 ≠ any base code: no match
    blob[R:R + windows.shape[1], :B] = windows.T
    blob[R + W:] = 0
    rl32 = np.asarray(read_lens, np.int32)
    wl32 = np.asarray(win_lens, np.int32)
    blob[R + W, :B] = rl32 & 0xFF
    blob[R + W + 1, :B] = rl32 >> 8
    blob[R + W + 2, :B] = wl32 & 0xFF
    blob[R + W + 3, :B] = wl32 >> 8

    ptrs, best, bestpos = _sw_device_fused(
        jnp.asarray(blob), params=params, R=R, W=W)

    # device traceback: the (D, R, B) pointer array stays on device and
    # the op stream + coords + scores come back as ONE d2h buffer.  Both
    # calls are enqueued now; the returned thunk performs the blocking d2h
    # + host walk when collected.
    fused_dev = _traceback_device(ptrs, best[0], bestpos[0],
                                  max_steps=R + W)
    rl = np.asarray(read_lens)

    def collect():
        fused = np.asarray(fused_dev)
        packed_h, coords_h, best_h = _decode_traceback(fused, R + W, B)
        return _results_from_packed(packed_h, R + W, coords_h, best_h, rl)
    return collect
