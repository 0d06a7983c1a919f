"""PairHMM kernel vs float64 golden model."""
import numpy as np
import pytest

from falcon_genome_tpu.ops.pairhmm import PairHMMParams, pairhmm_logp
from falcon_genome_tpu.ops.pairhmm_ref import (
    pairhmm_logp_ref, pairhmm_logp_single)

PARAMS = PairHMMParams(max_read_len=32, max_hap_len=48)


def make_pairs(rng, n, read_len=24, hap_len=40, mutate=0.05, qual=30):
    """Random haplotypes with reads sampled from them (with errors)."""
    B = n
    reads = np.zeros((B, read_len), dtype=np.uint8)
    haps = rng.integers(0, 4, size=(B, hap_len), dtype=np.uint8)
    for b in range(B):
        start = rng.integers(0, hap_len - read_len + 1)
        reads[b] = haps[b, start:start + read_len]
        nmut = rng.binomial(read_len, mutate)
        for _ in range(nmut):
            p = rng.integers(0, read_len)
            reads[b, p] = (reads[b, p] + rng.integers(1, 4)) % 4
    q = np.full((B, read_len), qual, dtype=np.uint8)
    gcp = np.full((B, read_len), 10, dtype=np.uint8)
    rl = np.full(B, read_len, dtype=np.int32)
    hl = np.full(B, hap_len, dtype=np.int32)
    return reads, q, q.copy(), q.copy(), gcp, rl, haps, hl


class TestGoldenModel:
    def test_perfect_match_likelihood_sane(self):
        hap = np.array([0, 1, 2, 3] * 5, dtype=np.uint8)
        read = hap[4:16].copy()
        q = np.full(12, 40, dtype=np.uint8)
        gcp = np.full(12, 10, dtype=np.uint8)
        lp = pairhmm_logp_single(read, q, q, q, gcp, hap)
        # perfect 12bp match, q40: ~ log10((1-2e-4)^12 / 20) ≈ -1.3
        assert -2.0 < lp < 0.0

    def test_mismatch_penalized(self):
        hap = np.array([0, 1, 2, 3] * 5, dtype=np.uint8)
        read = hap[4:16].copy()
        q = np.full(12, 40, dtype=np.uint8)
        gcp = np.full(12, 10, dtype=np.uint8)
        base = pairhmm_logp_single(read, q, q, q, gcp, hap)
        read_mm = read.copy()
        read_mm[5] = (read_mm[5] + 1) % 4
        worse = pairhmm_logp_single(read_mm, q, q, q, gcp, hap)
        assert worse < base - 3  # one q40 mismatch ≈ -4.5 log10

    def test_n_bases_neutral(self):
        hap = np.array([0, 1, 2, 3] * 5, dtype=np.uint8)
        read = hap[0:12].copy()
        q = np.full(12, 30, dtype=np.uint8)
        gcp = np.full(12, 10, dtype=np.uint8)
        base = pairhmm_logp_single(read, q, q, q, gcp, hap)
        read_n = read.copy()
        read_n[3] = 4  # N matches anything
        with_n = pairhmm_logp_single(read_n, q, q, q, gcp, hap)
        # N contributes (1-err) mass on every alignment path, so secondary
        # paths shift the total slightly; the primary path is unchanged.
        assert with_n == pytest.approx(base, abs=1e-4)


class TestKernelVsGolden:
    def test_batch_matches_golden(self, rng):
        args = make_pairs(rng, 8)
        got = np.asarray(pairhmm_logp(*args, params=PARAMS))
        want = pairhmm_logp_ref(*args)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)

    def test_variable_lengths(self, rng):
        reads, q, iq, dq, gcp, rl, haps, hl = make_pairs(rng, 6)
        rl = np.array([24, 20, 16, 24, 8, 12], dtype=np.int32)
        hl = np.array([40, 30, 40, 25, 40, 33], dtype=np.int32)
        got = np.asarray(pairhmm_logp(reads, q, iq, dq, gcp, rl, haps, hl,
                                      params=PARAMS))
        want = pairhmm_logp_ref(reads, q, iq, dq, gcp, rl, haps, hl)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)

    def test_indel_read(self, rng):
        # read with a deletion relative to hap still matches golden
        hap = rng.integers(0, 4, size=(1, 40), dtype=np.uint8)
        read = np.concatenate([hap[0, 5:15], hap[0, 18:30]]).reshape(1, -1)
        q = np.full((1, 22), 35, dtype=np.uint8)
        gcp = np.full((1, 22), 10, dtype=np.uint8)
        rl = np.array([22], dtype=np.int32)
        hl = np.array([40], dtype=np.int32)
        got = np.asarray(pairhmm_logp(read.astype(np.uint8), q, q, q, gcp,
                                      rl, hap, hl, params=PARAMS))
        want = pairhmm_logp_ref(read, q, q, q, gcp, rl, hap, hl)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)

    def test_rescaling_no_underflow(self, rng):
        # all-mismatch low-qual read: p ~ (err/3)^R, far below f32 range
        # without rescaling (2^120 * 1e-40 ... fine at R=24; use many
        # mismatches at q=40 → ~ -5 per base * 24 = -120 → needs rescue
        hap = np.zeros((1, 48), dtype=np.uint8)      # all A
        read = np.full((1, 24), 3, dtype=np.uint8)   # all T
        q = np.full((1, 24), 40, dtype=np.uint8)
        gcp = np.full((1, 24), 10, dtype=np.uint8)
        rl = np.array([24], dtype=np.int32)
        hl = np.array([48], dtype=np.int32)
        got = np.asarray(pairhmm_logp(read, q, q, q, gcp, rl, hap, hl,
                                      params=PARAMS))
        want = pairhmm_logp_ref(read, q, q, q, gcp, rl, hap, hl)
        assert np.isfinite(got[0])
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)

    def test_best_hap_wins(self, rng):
        # a read should score best against the hap it came from
        reads, q, iq, dq, gcp, rl, haps, hl = make_pairs(rng, 4, mutate=0.0)
        B = 4
        # score read 0 against every hap
        r0 = np.tile(reads[0:1], (B, 1))
        q0 = np.tile(q[0:1], (B, 1))
        g0 = np.tile(gcp[0:1], (B, 1))
        got = np.asarray(pairhmm_logp(r0, q0, q0, q0, g0,
                                      np.full(B, 24, np.int32), haps, hl,
                                      params=PARAMS))
        assert got.argmax() == 0


class TestPairIndexedDispatch:
    def test_matches_per_pair_path(self, rng):
        from falcon_genome_tpu.ops.pairhmm import (
            PairHMMParams, pairhmm_logp, pairhmm_logp_pairs)
        NR, NH, RL, HL = 6, 3, 24, 40
        haps = rng.integers(0, 4, (NH, HL)).astype(np.uint8)
        reads = np.empty((NR, RL), np.uint8)
        for i in range(NR):
            s = rng.integers(0, HL - RL + 1)
            reads[i] = haps[i % NH, s:s + RL]
        quals = rng.integers(25, 40, (NR, RL)).astype(np.uint8)
        rl = np.full(NR, RL, np.int32)
        hl = np.full(NH, HL, np.int32)
        pr = np.repeat(np.arange(NR), NH)
        ph = np.tile(np.arange(NH), NR)
        p = PairHMMParams(max_read_len=32, max_hap_len=64)
        got = pairhmm_logp_pairs(reads, quals, rl, haps, hl, pr, ph,
                                 45, 45, 10, params=p)
        want = np.asarray(pairhmm_logp(
            reads[pr], quals[pr], 45, 45, 10, rl[pr], haps[ph], hl[ph],
            params=p))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)

    def test_ragged_lengths(self, rng):
        from falcon_genome_tpu.ops.pairhmm import (
            PairHMMParams, pairhmm_logp, pairhmm_logp_pairs)
        NR, NH = 5, 4
        haps = rng.integers(0, 4, (NH, 48)).astype(np.uint8)
        reads = rng.integers(0, 4, (NR, 24)).astype(np.uint8)
        quals = np.full((NR, 24), 30, np.uint8)
        rl = np.array([24, 16, 20, 8, 24], np.int32)
        hl = np.array([48, 30, 40, 25], np.int32)
        pr = rng.integers(0, NR, 11).astype(np.int64)
        ph = rng.integers(0, NH, 11).astype(np.int64)
        p = PairHMMParams(max_read_len=32, max_hap_len=64)
        got = pairhmm_logp_pairs(reads, quals, rl, haps, hl, pr, ph,
                                 45, 45, 10, params=p)
        want = np.asarray(pairhmm_logp(
            reads[pr], quals[pr], 45, 45, 10, rl[pr], haps[ph], hl[ph],
            params=p))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
