"""The CUDA kernels' strip tiling, emulated in NumPy, against the goldens.

``native/dp_kernels.cu`` cannot run here (no interpret mode for CUDA), so
these emulations follow it step by step — 32 rows per warp, lane t at
column k - t + 1 on step k, the row above arriving from lane t-1, the last
row of a strip handed to lane 0 of the next through a buffer, the PairHMM
rescale check at each strip boundary — in float32 / int32, vectorized over
pairs.  The card runs the real kernels against the same goldens
(``chip_smoke.py``).
"""
import numpy as np
import pytest

from falcon_genome_tpu.ops.pairhmm import (
    LOG10_INITIAL, RESCALE_FACTOR, RESCALE_SHIFT_LOG10, RESCALE_THRESH)
from falcon_genome_tpu.ops.pairhmm_ref import pairhmm_logp_ref_batch
from falcon_genome_tpu.ops.sw_ref import NEG, SWParams, sw_score_ref_batch

WARP = 32


def _shift_lanes(x, fill):
    """__shfl_up_sync(x, 1) with lane 0 taking ``fill``."""
    return np.concatenate([fill[:, None], x[:, :-1]], axis=1)


def emulate_pairhmm(read, perr, rlen, hap, hlen, p_ins, p_del, p_cont):
    """fg_pairhmm_fwd: returns (acc, shift, n_rescaled_strips)."""
    f32 = np.float32
    B, R = read.shape
    H = hap.shape[1]
    p_ins, p_del, p_cont = f32(p_ins), f32(p_del), f32(p_cont)
    a_mm = f32(1) - min(f32(1), p_ins + p_del)
    a_im = f32(1) - p_cont
    rl = np.minimum(rlen, R)
    hl = np.minimum(hlen, H)
    bound_dg = (f32(2.0 ** 120) / np.maximum(hlen.astype(f32), f32(1))) * a_im
    hand = np.zeros((B, H + 2, 2), f32)
    acc = np.zeros((B, WARP), f32)
    shift = np.zeros(B, f32)
    rescaled = np.zeros(B, np.int64)
    lane = np.arange(WARP)
    nstrips = (rl + WARP - 1) // WARP
    for s in range(int(nstrips.max(initial=0))):
        live = s < nstrips                                   # (B,)
        r = s * WARP + lane
        row_ok = r[None, :] < rl[:, None]
        rc = np.where(row_ok, read[:, np.minimum(r, R - 1)], 4)
        pe = np.where(row_ok, perr[:, np.minimum(r, R - 1)], f32(0))
        prior_match = f32(1) - pe
        prior_mismatch = pe / f32(3)
        last_row = r[None, :] == rl[:, None] - 1
        hand_off = s + 1 < nstrips
        diag_in = np.zeros((B, WARP), f32)
        if s == 0:
            diag_in[:, 0] = bound_dg
        left = np.zeros((B, WARP), f32)
        tdg_out = np.zeros((B, WARP), f32)
        tup_out = np.zeros((B, WARP), f32)
        for k in range(int(hl.max()) + WARP - 1):
            j = k - lane + 1                                 # (32,)
            j0 = min(k + 1, H + 1)                           # lane 0 column
            if s == 0:
                fill_dg, fill_up = bound_dg, np.zeros(B, f32)
            else:
                ok0 = k + 1 <= hl
                fill_dg = np.where(ok0, hand[:, j0, 0], f32(0))
                fill_up = np.where(ok0, hand[:, j0, 1], f32(0))
            up_dg = _shift_lanes(tdg_out, fill_dg)
            up_up = _shift_lanes(tup_out, fill_up)
            active = (j[None, :] >= 1) & (j[None, :] <= hl[:, None])
            hc = hap[:, np.clip(j - 1, 0, H - 1)]
            match = (rc == hc) | (rc >= 4) | (hc >= 4)
            m = np.where(match, prior_match, prior_mismatch) * diag_in
            i, d = up_up, left
            left = np.where(active, m * p_del + d * p_cont, left)
            tdg = np.where(active, m * a_mm + (i + d) * a_im, f32(0))
            tup = np.where(active, m * p_ins + i * p_cont, f32(0))
            acc += np.where(active & last_row, m + i, f32(0))
            diag_in = up_dg
            tdg_out, tup_out = tdg, tup
            j31 = k - (WARP - 1) + 1
            if 1 <= j31:
                w = hand_off & live & (j31 <= hl)
                hand[w, j31, 0] = tdg[w, -1]
                hand[w, j31, 1] = tup[w, -1]
        cols = np.arange(H + 2)[None, :]
        inside = (cols >= 1) & (cols <= hl[:, None])
        mx = np.where(inside, np.abs(hand).max(axis=2), f32(0)).max(axis=1)
        need = hand_off & live & (mx > 0) & (mx < f32(RESCALE_THRESH))
        hand[need] *= f32(RESCALE_FACTOR)
        shift[need] += f32(RESCALE_SHIFT_LOG10)
        rescaled += need
    return acc.sum(axis=1, dtype=f32), shift, rescaled


def emulate_sw_score(read, rlen, win, wlen, params=SWParams()):
    """fg_sw_score: best local score per pair."""
    B, R = read.shape
    W = win.shape[1]
    go = params.gap_open + params.gap_ext
    ge = params.gap_ext
    rl = np.minimum(rlen, R)
    wl = np.minimum(wlen, W)
    hand = np.zeros((B, W + 2, 2), np.int64)
    best = np.zeros((B, WARP), np.int64)
    lane = np.arange(WARP)
    nstrips = (rl + WARP - 1) // WARP
    for s in range(int(nstrips.max(initial=0))):
        live = s < nstrips
        r = s * WARP + lane
        row_ok = r[None, :] < rl[:, None]
        rc = np.where(row_ok, read[:, np.minimum(r, R - 1)], 4)
        hand_off = s + 1 < nstrips
        diag_in = np.zeros((B, WARP), np.int64)
        h_left = np.zeros((B, WARP), np.int64)
        e_left = np.full((B, WARP), NEG, np.int64)
        h_out = np.zeros((B, WARP), np.int64)
        f_out = np.full((B, WARP), NEG, np.int64)
        for k in range(int(wl.max()) + WARP - 1):
            j = k - lane + 1
            j0 = min(k + 1, W + 1)
            ok0 = (s > 0) & (k + 1 <= wl)
            up_h = _shift_lanes(h_out, np.where(ok0, hand[:, j0, 0], 0))
            up_f = _shift_lanes(f_out, np.where(ok0, hand[:, j0, 1], NEG))
            active = row_ok & (j[None, :] >= 1) & (j[None, :] <= wl[:, None])
            e = np.maximum(h_left - go, e_left - ge)
            f = np.maximum(up_h - go, up_f - ge)
            wc = win[:, np.clip(j - 1, 0, W - 1)]
            dg = diag_in + np.where(rc == wc, params.match, -params.mismatch)
            h = np.maximum(np.maximum(0, dg), np.maximum(e, f))
            h = np.where(active, h, 0)
            e = np.where(active, e, NEG)
            f = np.where(active, f, NEG)
            best = np.maximum(best, h)
            h_left, e_left = h, e
            diag_in = up_h
            h_out, f_out = h, f
            j31 = k - (WARP - 1) + 1
            if 1 <= j31:
                w = hand_off & live & (j31 <= wl)
                hand[w, j31, 0] = h[w, -1]
                hand[w, j31, 1] = f[w, -1]
    return best.max(axis=1).astype(np.int32)


def _logp(acc, shift):
    with np.errstate(divide="ignore"):
        return np.where(acc > 0, np.log10(np.maximum(
            acc, np.finfo(np.float32).tiny)) - shift - LOG10_INITIAL,
            -np.inf)


def _pairs(rng, B, R, H, rlens, hlens, mutate, qual):
    haps = rng.integers(0, 4, (B, H)).astype(np.uint8)
    reads = np.full((B, R), 4, np.uint8)
    for b in range(B):
        rl, hl = rlens[b], hlens[b]
        s = rng.integers(0, max(hl - rl, 0) + 1)
        seg = haps[b, s:s + rl]
        reads[b, :len(seg)] = seg
        reads[b, len(seg):rl] = rng.integers(0, 4, rl - len(seg))
    mut = (rng.random((B, R)) < mutate) & (reads < 4)
    reads = np.where(mut, (reads + 1) % 4, reads).astype(np.uint8)
    quals = np.full((B, R), qual, np.uint8)
    return reads, quals, haps


@pytest.mark.parametrize("rows", [24, 32, 33, 70, 96])
def test_pairhmm_strips_match_golden(rng, rows):
    """Strip counts 1, 1, 2, 3, 3 — including a one-row last strip."""
    B, H = 6, 80
    rl = np.full(B, rows)
    rl[1] = max(rows - 5, 1)
    hl = np.array([80, 64, 70, 55, 80, 41])
    reads, quals, haps = _pairs(rng, B, rows, H, rl, hl, 0.03, 30)
    perr = np.power(np.float32(10), -quals.astype(np.float32) / 10)
    acc, shift, _ = emulate_pairhmm(reads, perr, rl, haps, hl,
                                    10 ** -4.5, 10 ** -4.5, 0.1)
    want = pairhmm_logp_ref_batch(reads, quals, 45, 45, 10, rl, haps, hl)
    np.testing.assert_allclose(_logp(acc, shift), want, rtol=0, atol=2e-3)


def test_pairhmm_strip_rescale_rescues(rng):
    """Unrelated read and hap at q20 over 96 rows: the mass falls below
    f32's range without the strip-boundary rescale."""
    B, R, H = 4, 96, 64
    rl = np.full(B, R)
    hl = np.full(B, H)
    reads = rng.integers(0, 4, (B, R)).astype(np.uint8)
    haps = rng.integers(0, 4, (B, H)).astype(np.uint8)
    quals = np.full((B, R), 20, np.uint8)
    perr = np.power(np.float32(10), -quals.astype(np.float32) / 10)
    acc, shift, rescaled = emulate_pairhmm(reads, perr, rl, haps, hl,
                                           10 ** -4.5, 10 ** -4.5, 0.1)
    want = pairhmm_logp_ref_batch(reads, quals, 45, 45, 10, rl, haps, hl)
    assert (rescaled > 0).all()
    # unscaled, the final mass 10^(LOG10_INITIAL + want) is below f32's
    # smallest subnormal (~1.4e-45)
    assert np.isfinite(want).all() and (want < -LOG10_INITIAL - 46).all()
    np.testing.assert_allclose(_logp(acc, shift), want, rtol=0, atol=5e-3)


@pytest.mark.parametrize("rows", [20, 32, 45, 100])
def test_sw_strips_match_golden(rng, rows):
    B, W = 8, 90
    rl = np.full(B, rows)
    rl[2] = rows // 2 + 1
    wl = np.array([90, 80, 75, 90, 60, 90, 33, 88])
    reads, _, wins = _pairs(rng, B, rows, W, rl, wl, 0.08, 30)
    got = emulate_sw_score(reads, rl, wins, wl)
    np.testing.assert_array_equal(got,
                                  sw_score_ref_batch(reads, rl, wins, wl))


def test_sw_strips_hap_to_ref_scoring(rng):
    """The caller's heavier gap scoring (hap-to-ref alignment)."""
    params = SWParams(match=2, mismatch=6, gap_open=12, gap_ext=1)
    B, R, W = 5, 70, 90
    rl = np.full(B, R)
    wl = np.full(B, W)
    reads, _, wins = _pairs(rng, B, R, W, rl, wl, 0.05, 30)
    np.testing.assert_array_equal(
        emulate_sw_score(reads, rl, wins, wl, params),
        sw_score_ref_batch(reads, rl, wins, wl, params))


@pytest.mark.gpu
def test_cuda_pairhmm_matches_golden(gpu_device, rng):
    import jax
    from falcon_genome_tpu.ops import gpu_kernels
    B, R, H = 64, 160, 384
    rl = np.full(B, 152)
    hl = rng.integers(200, H + 1, B)
    reads, quals, haps = _pairs(rng, B, R, H, rl, hl, 0.02, 30)
    perr = np.power(np.float32(10), -quals.astype(np.float32) / 10)
    acc, shift = jax.jit(lambda *a: gpu_kernels.pairhmm_fwd(
        *a, p_ins=10 ** -4.5, p_del=10 ** -4.5, p_cont=0.1))(
        reads, perr, rl.astype(np.int32), haps, hl.astype(np.int32))
    want = pairhmm_logp_ref_batch(reads, quals, 45, 45, 10, rl, haps, hl)
    np.testing.assert_allclose(_logp(np.asarray(acc), np.asarray(shift)),
                               want, rtol=0, atol=2e-3)


@pytest.mark.gpu
def test_cuda_sw_score_matches_golden(gpu_device, rng):
    import jax
    from falcon_genome_tpu.ops import gpu_kernels
    B, R, W = 64, 160, 256
    rl = np.full(B, 150)
    wl = np.full(B, 214)
    reads, _, wins = _pairs(rng, B, R, W, rl, wl, 0.03, 30)
    p = SWParams()
    got = jax.jit(lambda *a: gpu_kernels.sw_score(
        *a, match=p.match, mismatch=p.mismatch, gap_open=p.gap_open,
        gap_ext=p.gap_ext))(reads, rl.astype(np.int32), wins,
                            wl.astype(np.int32))
    np.testing.assert_array_equal(np.asarray(got),
                                  sw_score_ref_batch(reads, rl, wins, wl))
