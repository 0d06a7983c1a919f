"""Smith-Waterman kernel vs NumPy golden model."""
import numpy as np
import pytest

from falcon_genome_tpu.io.sam import cigar_query_len, cigar_ref_len, cigar_to_str
from falcon_genome_tpu.ops.smith_waterman import (
    SWBucket, SWParams, sw_extend_batch)
from falcon_genome_tpu.ops.sw_ref import sw_align_ref

BUCKET = SWBucket(max_read_len=32, max_win_len=64)


def make_batch(rng, n, read_len=24, win_len=48, mutate=0.0, indel=0.0):
    wins = rng.integers(0, 4, size=(n, win_len), dtype=np.uint8)
    reads = np.zeros((n, read_len), dtype=np.uint8)
    for b in range(n):
        s = rng.integers(0, win_len - read_len + 1)
        seg = list(wins[b, s:s + read_len + 8][:read_len + 8])
        out = []
        i = 0
        while len(out) < read_len and i < len(seg):
            r = rng.random()
            if r < mutate:
                out.append((seg[i] + rng.integers(1, 4)) % 4)
                i += 1
            elif r < mutate + indel / 2:
                i += 1  # deletion in read
            elif r < mutate + indel:
                out.append(rng.integers(0, 4))  # insertion
            else:
                out.append(seg[i])
                i += 1
        while len(out) < read_len:
            out.append(rng.integers(0, 4))
        reads[b] = out[:read_len]
    rl = np.full(n, read_len, dtype=np.int32)
    wl = np.full(n, win_len, dtype=np.int32)
    return reads, rl, wins, wl


def check_vs_golden(reads, rl, wins, wl, results, check_pos=True):
    for b in range(len(reads)):
        want = sw_align_ref(reads[b, :rl[b]], wins[b, :wl[b]])
        got = results[b]
        assert got.score == want.score, f"pair {b} score"
        # CIGAR must be self-consistent even if tie-broken differently
        assert cigar_query_len(got.cigar) == rl[b]
        assert cigar_ref_len([op for op in got.cigar if op[0] != 4]) == \
            got.ref_end - got.ref_start
        if check_pos:
            assert (got.read_start, got.read_end, got.ref_start,
                    got.ref_end) == (want.read_start, want.read_end,
                                     want.ref_start, want.ref_end), f"pair {b}"
            assert cigar_to_str(got.cigar) == cigar_to_str(want.cigar), \
                f"pair {b}"


class TestGolden:
    def test_perfect_match(self):
        rng = np.random.default_rng(42)
        win = rng.integers(0, 4, 32).astype(np.uint8)
        read = win[8:20].copy()
        res = sw_align_ref(read, win)
        assert res.score == 12
        assert cigar_to_str(res.cigar) == "12M"
        assert res.ref_start == 8

    def test_mismatch_and_clip(self):
        rng = np.random.default_rng(43)
        win = rng.integers(0, 4, 32).astype(np.uint8)
        read = win[8:20].copy()
        read[0] = (read[0] + 1) % 4  # mismatch at first base → clipped
        res = sw_align_ref(read, win)
        assert res.cigar[0][0] == 4  # soft clip
        assert res.score == 11

    def test_deletion(self):
        win = np.arange(32, dtype=np.uint8) % 4
        # read skips 2 window bases in the middle
        read = np.concatenate([win[4:14], win[16:26]])
        res = sw_align_ref(read, win)
        assert "D" in cigar_to_str(res.cigar)
        assert res.score == 20 - (6 + 2 * 1)

    def test_insertion(self):
        win = (np.arange(32, dtype=np.uint8) * 3) % 4
        read = np.concatenate(
            [win[4:14], np.array([3, 3], dtype=np.uint8) if win[13] != 3
             else np.array([0, 0], dtype=np.uint8), win[14:24]])
        res = sw_align_ref(read, win)
        assert "I" in cigar_to_str(res.cigar)


class TestKernelVsGolden:
    def test_exact_reads(self, rng):
        args = make_batch(rng, 8)
        res = sw_extend_batch(*args, bucket=BUCKET)
        check_vs_golden(*args, res)

    def test_mutated_reads(self, rng):
        args = make_batch(rng, 16, mutate=0.08)
        res = sw_extend_batch(*args, bucket=BUCKET)
        check_vs_golden(*args, res)

    def test_indel_reads(self, rng):
        args = make_batch(rng, 16, mutate=0.03, indel=0.06)
        res = sw_extend_batch(*args, bucket=BUCKET)
        # indel placement can tie; require score equality + valid cigars
        check_vs_golden(*args, res, check_pos=False)

    def test_variable_lengths(self, rng):
        reads, rl, wins, wl = make_batch(rng, 6)
        rl = np.array([24, 16, 20, 24, 12, 8], dtype=np.int32)
        wl = np.array([48, 40, 30, 25, 48, 33], dtype=np.int32)
        res = sw_extend_batch(reads, rl, wins, wl, bucket=BUCKET)
        check_vs_golden(reads, rl, wins, wl, res, check_pos=False)

    def test_unalignable_read(self, rng):
        # window of A's, read of T's → no positive-scoring cell
        reads = np.full((1, 24), 3, dtype=np.uint8)
        wins = np.zeros((1, 48), dtype=np.uint8)
        res = sw_extend_batch(reads, np.array([24], np.int32), wins,
                              np.array([48], np.int32), bucket=BUCKET)
        assert res[0].score == 0
        assert cigar_to_str(res[0].cigar) == "24S"
