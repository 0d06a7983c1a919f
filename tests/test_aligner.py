"""Aligner engine tests: simulated reads must map back to their origin.

This is the in-repo analog of the reference's compareBAM gate
(scripts/compareBAM.sh): ground truth is the simulation, the gate is
position/strand/CIGAR recovery.
"""
import numpy as np
import pytest

from falcon_genome_tpu.aligner import (
    AlignerEngine, AlignerParams, IndexParams, MinimizerIndex,
    find_candidates, make_sam_records, _minimizers, _pack_kmers,
    _revcomp_kmers)
from falcon_genome_tpu.io.dna import decode_seq, encode_seq, revcomp_codes
from falcon_genome_tpu.io.sam import (
    FLAG_PROPER_PAIR, FLAG_REVERSE, FLAG_UNMAPPED, cigar_to_str)
from falcon_genome_tpu.ops.smith_waterman import SWBucket

BUCKET = SWBucket(max_read_len=128, max_win_len=256)


@pytest.fixture(scope="module")
def genome(  ):
    rng = np.random.default_rng(7)
    chr1 = rng.integers(0, 4, 5000).astype(np.uint8)
    chr2 = rng.integers(0, 4, 3000).astype(np.uint8)
    return [("chr1", chr1), ("chr2", chr2)]


@pytest.fixture(scope="module")
def index(genome):
    return MinimizerIndex(genome, IndexParams(k=15, w=5))


@pytest.fixture(scope="module")
def engine(index):
    return AlignerEngine(index, AlignerParams(), bucket=BUCKET)


def sample_reads(genome, rng, n, read_len=100, error=0.0, revcomp_frac=0.5):
    """Returns (codes, lengths, truth=(contig, pos, is_rev))."""
    codes = np.zeros((n, read_len), dtype=np.uint8)
    truth = []
    for i in range(n):
        tid = rng.integers(0, len(genome))
        name, seq = genome[tid]
        pos = rng.integers(0, len(seq) - read_len)
        r = seq[pos:pos + read_len].copy()
        nerr = rng.binomial(read_len, error)
        for _ in range(nerr):
            p = rng.integers(0, read_len)
            r[p] = (r[p] + rng.integers(1, 4)) % 4
        is_rev = rng.random() < revcomp_frac
        codes[i] = revcomp_codes(r) if is_rev else r
        truth.append((name, int(pos), is_rev))
    return codes, np.full(n, read_len, np.int32), truth


class TestKmers:
    def test_revcomp_kmers(self):
        seq = encode_seq("ACGTTGCA")
        k = 4
        kmers, ok = _pack_kmers(seq, k)
        rc = _revcomp_kmers(kmers, k)
        # ACGT revcomp is ACGT (palindrome)
        assert rc[0] == kmers[0]
        # GTTG -> CAAC
        want, _ = _pack_kmers(encode_seq("CAAC"), 4)
        assert rc[2] == want[0]

    def test_minimizers_cover_sequence(self, rng):
        seq = rng.integers(0, 4, 500).astype(np.uint8)
        h, pos, strand = _minimizers(seq, 15, 5)
        assert len(h) > 20           # dense enough
        assert (np.diff(pos) > 0).all()
        assert (np.diff(pos) <= 5 + 15).all()  # no gap larger than w+k

    def test_minimizers_strand_symmetric(self, rng):
        seq = rng.integers(0, 4, 200).astype(np.uint8)
        h1, _, _ = _minimizers(seq, 15, 5)
        h2, _, _ = _minimizers(revcomp_codes(seq), 15, 5)
        assert set(h1.tolist()) == set(h2.tolist())

    def test_n_bases_excluded(self):
        seq = np.full(60, 4, dtype=np.uint8)  # all N
        h, pos, strand = _minimizers(seq, 15, 5)
        assert len(h) == 0


class TestCandidates:
    def test_exact_read_found(self, index, genome):
        seq = genome[0][1]
        read = seq[1000:1100]
        cands = find_candidates(read, index, AlignerParams())
        assert cands
        assert abs(cands[0].gdiag - 1000) <= 2
        assert not cands[0].is_rev

    def test_revcomp_read_found(self, index, genome):
        seq = genome[1][1]
        read = revcomp_codes(seq[500:600])
        cands = find_candidates(read, index, AlignerParams())
        assert cands
        assert cands[0].is_rev
        # chr2 offset is 5000
        assert abs(cands[0].gdiag - 5500) <= 2


class TestAlignBatch:
    def test_exact_reads(self, engine, genome, rng):
        codes, lens, truth = sample_reads(genome, rng, 24)
        res = engine.align_batch(codes, lens)
        for a, (contig, pos, is_rev) in zip(res, truth):
            assert a.mapped
            assert engine.index.contig_names[a.tid] == contig
            assert a.pos == pos
            assert a.is_rev == is_rev
            assert cigar_to_str(a.cigar) == "100M"
            assert a.nm == 0
            assert a.score == 100
            assert a.mapq >= 30

    def test_reads_with_errors(self, engine, genome, rng):
        codes, lens, truth = sample_reads(genome, rng, 24, error=0.02)
        res = engine.align_batch(codes, lens)
        mapped = sum(a.mapped for a in res)
        assert mapped >= 23
        correct = sum(
            a.mapped and engine.index.contig_names[a.tid] == c and
            abs(a.pos - p) <= 3 and a.is_rev == s
            for a, (c, p, s) in zip(res, truth))
        assert correct >= 22

    def test_garbage_read_unmapped(self, engine, rng):
        codes = rng.integers(0, 4, size=(1, 100)).astype(np.uint8)
        res = engine.align_batch(codes, np.array([100], np.int32))
        # random 100-mer almost surely has no 15-mer minimizer match chain
        if res[0].mapped:
            assert res[0].mapq <= 10

    def test_deletion_read(self, engine, genome):
        seq = genome[0][1]
        read = np.concatenate([seq[2000:2050], seq[2055:2105]])
        res = engine.align_batch(read.reshape(1, -1),
                                 np.array([100], np.int32))
        a = res[0]
        assert a.mapped and a.pos == 2000
        assert "D" in cigar_to_str(a.cigar)
        assert a.nm == 5


class TestSamEmission:
    def test_paired_proper(self, engine, genome):
        seq = genome[0][1]
        r1 = seq[3000:3100]
        r2 = revcomp_codes(seq[3200:3300])
        res = engine.align_batch(
            np.stack([r1, r2]), np.full(2, 100, np.int32))
        recs = make_sam_records(
            "frag1", decode_seq(r1), "I" * 100, res[0],
            decode_seq(r2), "I" * 100, res[1], read_group="rg1")
        assert len(recs) == 2
        assert recs[0].flag & FLAG_PROPER_PAIR
        assert recs[1].flag & FLAG_PROPER_PAIR
        assert recs[1].flag & FLAG_REVERSE
        assert recs[0].tlen == 300
        assert recs[1].tlen == -300
        assert recs[0].get_tag("RG") == "rg1"
        # reverse mate's stored seq is the reference-forward orientation
        assert recs[1].seq == decode_seq(seq[3200:3300])

    def test_unmapped_single(self):
        from falcon_genome_tpu.aligner import Alignment
        rec, = make_sam_records("r", "ACGT", "IIII",
                                Alignment(mapped=False, read_len=4))
        assert rec.flag & FLAG_UNMAPPED
        assert rec.tid == -1


class TestPairAware:
    def _frag(self, genome, rng, tid, pos, frag=400, rl=100):
        name, seq = genome[tid]
        r1 = seq[pos:pos + rl].copy()
        r2 = revcomp_codes(seq[pos + frag - rl:pos + frag].copy())
        return r1, r2

    def test_pair_bonus_disambiguates_repeat(self, rng):
        # genome with an exact repeat: R1 seeds both copies equally, only
        # the proper-pair combo with R2 picks the right copy
        rng2 = np.random.default_rng(11)
        unit = rng2.integers(0, 4, 300).astype(np.uint8)
        spacer = rng2.integers(0, 4, 2000).astype(np.uint8)
        chrom = np.concatenate([unit, spacer, unit,
                                rng2.integers(0, 4, 1000).astype(np.uint8)])
        idx = MinimizerIndex([("c", chrom)], IndexParams(k=15, w=5))
        eng = AlignerEngine(idx, AlignerParams(), bucket=BUCKET)
        rl = 100
        copy2 = 300 + 2000                      # start of second unit copy
        r1 = chrom[copy2:copy2 + rl]            # inside the repeat (copy 2)
        mate_pos = copy2 + 350 - rl             # unique spacer after copy 2
        r2 = revcomp_codes(chrom[mate_pos:mate_pos + 350 - (350 - rl)
                                 + (350 - rl)][:rl].copy())
        r2 = revcomp_codes(chrom[copy2 + 250:copy2 + 350].copy())
        a1, a2 = eng.align_pair_batch(
            r1[None, :], np.array([rl]), r2[None, :], np.array([rl]))
        assert a1[0].mapped and a2[0].mapped
        assert a1[0].pos == copy2               # repeat resolved by the mate
        assert a2[0].pos == copy2 + 250
        assert not a1[0].is_rev and a2[0].is_rev

    def test_mate_rescue_recovers_seedless_mate(self, genome, rng):
        # every 10th base of mate 2 mutated: no clean 15-mer seeds exist
        # (max run 9 < k), but 90% identity scores well above the rescue
        # threshold — rescue must place it in the anchor's insert window
        name, seq = genome[0]
        rl, frag, pos = 100, 350, 1200
        r1 = seq[pos:pos + rl].copy()
        r2f = seq[pos + frag - rl:pos + frag].copy()
        rng3 = np.random.default_rng(5)
        mut = r2f.copy()
        for p in range(0, rl, 10):              # every 10th base mutated
            mut[p] = (mut[p] + 1 + rng3.integers(0, 3)) % 4
        r2 = revcomp_codes(mut)
        idx = MinimizerIndex(genome, IndexParams(k=15, w=5))
        eng = AlignerEngine(idx, AlignerParams(), bucket=BUCKET)
        # sanity: no candidates for the mutated mate on its own
        assert not find_candidates(r2, idx, eng.params)
        a1, a2 = eng.align_pair_batch(
            r1[None, :], np.array([rl]), r2[None, :], np.array([rl]))
        assert a1[0].mapped
        assert a2[0].mapped, "mate rescue failed"
        assert a2[0].is_rev
        assert abs(a2[0].pos - (pos + frag - rl)) <= 8

    def test_pairs_still_align_plain(self, engine, genome, rng):
        codes, lens, truth = sample_reads(genome, rng, 16, error=0.01,
                                          revcomp_frac=0.0)
        # build mates 250bp downstream on the reverse strand
        codes2 = np.zeros_like(codes)
        for i, (cname, pos, _) in enumerate(truth):
            seq = dict(genome)[cname]
            s = min(pos + 150, len(seq) - 100)
            codes2[i] = revcomp_codes(seq[s:s + 100].copy())
        a1, a2 = engine.align_pair_batch(codes, lens, codes2, lens)
        ok = sum(1 for i, (cname, pos, _) in enumerate(truth)
                 if a1[i].mapped and a1[i].pos == pos)
        assert ok >= 15
