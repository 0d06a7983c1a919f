"""Native fgio extension vs pure-Python reference implementations."""
import gzip

import numpy as np
import pytest

from falcon_genome_tpu.io import native_ext

pytestmark = pytest.mark.skipif(not native_ext.available(),
                                reason="native fgio not built")


class TestBgzf:
    def test_roundtrip_gzip_readable(self):
        data = b"the quick brown fox " * 50000  # ~1MB, multi-block
        out = native_ext.bgzf_compress(data)
        assert out is not None
        assert gzip.decompress(out) == data
        # BGZF magic with BC subfield
        assert out[:4] == b"\x1f\x8b\x08\x04"
        assert out[12:14] == b"BC"

    def test_empty(self):
        out = native_ext.bgzf_compress(b"")
        assert out == b""

    def test_writer_integration(self, tmp_path):
        from falcon_genome_tpu.io.bgzf import BgzfReader, BgzfWriter
        p = tmp_path / "x.bgzf"
        payload = bytes(range(256)) * 1000
        with BgzfWriter(p) as w:
            w.write(payload)
        with BgzfReader(p) as r:
            assert r.read() == payload


class TestMinimizers:
    @pytest.mark.parametrize("n,k,w", [(500, 15, 5), (100, 21, 11),
                                       (30, 15, 5), (14, 15, 5)])
    def test_matches_python(self, rng, n, k, w):
        from falcon_genome_tpu.aligner import _minimizers_py
        codes = rng.integers(0, 4, n).astype(np.uint8)
        got = native_ext.minimizers(codes, k, w)
        want = _minimizers_py(codes, k, w)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])

    def test_n_bases_match_python(self, rng):
        from falcon_genome_tpu.aligner import _minimizers_py
        codes = rng.integers(0, 4, 300).astype(np.uint8)
        codes[50:70] = 4
        codes[200] = 4
        got = native_ext.minimizers(codes, 15, 5)
        want = _minimizers_py(codes, 15, 5)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


class TestTraceback:
    def test_matches_python(self, rng):
        from falcon_genome_tpu.ops.smith_waterman import (
            SWBucket, sw_extend_batch)
        from falcon_genome_tpu.ops.sw_ref import sw_align_ref
        import falcon_genome_tpu.io.native_ext as ne

        n, rl, wl = 12, 40, 80
        wins = rng.integers(0, 4, (n, wl)).astype(np.uint8)
        reads = np.zeros((n, rl), np.uint8)
        for b in range(n):
            s = rng.integers(0, wl - rl)
            reads[b] = wins[b, s:s + rl]
            for _ in range(3):
                p = rng.integers(0, rl)
                reads[b, p] = (reads[b, p] + rng.integers(1, 4)) % 4
        res = sw_extend_batch(
            reads, np.full(n, rl, np.int32), wins,
            np.full(n, wl, np.int32),
            bucket=SWBucket(max_read_len=64, max_win_len=128))
        # native path was used (available); compare against golden
        for b in range(n):
            want = sw_align_ref(reads[b], wins[b])
            assert res[b].score == want.score
            assert res[b].cigar == want.cigar or \
                sum(x for _, x in res[b].cigar) == \
                sum(x for _, x in want.cigar)


class TestOpsRle:
    def test_matches_python_rle(self, rng):
        """Native packed-op RLE must equal the python unpack+RLE path."""
        from falcon_genome_tpu.ops.smith_waterman import (
            _results_from_device_traceback, _unpack_ops)
        import falcon_genome_tpu.io.native_ext as ne
        if not ne.available():
            import pytest
            pytest.skip("native fgio not built")

        B, S = 37, 96
        # random biased 2-bit op streams incl. none(0) runs
        ops = rng.integers(-1, 3, (S, B)).astype(np.int8)
        best = rng.integers(0, 30, B).astype(np.int32)
        best[::5] = 0                       # some unmapped lanes
        i_f = rng.integers(0, 10, B).astype(np.int32)
        j_f = rng.integers(0, 10, B).astype(np.int32)
        bi = (i_f + rng.integers(0, 50, B)).astype(np.int32)
        bj = (j_f + rng.integers(0, 50, B)).astype(np.int32)
        rl = (bi + rng.integers(0, 20, B)).astype(np.int32)

        S4 = (S + 3) // 4 * 4
        ops2 = np.zeros((S4, B), np.uint8)
        ops2[:S] = (ops + 1).astype(np.uint8)
        o = ops2.reshape(S4 // 4, 4, B)
        packed = (o[:, 0] | (o[:, 1] << 2) | (o[:, 2] << 4)
                  | (o[:, 3] << 6)).astype(np.uint8)

        assert np.array_equal(_unpack_ops(packed, S), ops)

        want = _results_from_device_traceback(ops, i_f, j_f, bi, bj,
                                              best, rl)
        got_ops, got_lens, got_nc = ne.ops_rle_batch(
            packed, S, i_f, bi, best, rl)
        for b in range(B):
            n = int(got_nc[b])
            cigar = list(zip(got_ops[b, :n].tolist(),
                             got_lens[b, :n].tolist()))
            assert cigar == want[b].cigar, (b, cigar, want[b].cigar)


class TestBamScan:
    def test_matches_python_decoder(self, rng, tmp_path):
        """Native columnar BAM scan must reproduce the streaming python
        decoder record-for-record, including lazily-parsed tags."""
        import falcon_genome_tpu.io.native_ext as ne
        if not ne.available():
            import pytest
            pytest.skip("native fgio not built")
        from falcon_genome_tpu.io.bam import (
            BamReader, read_bam, write_bam)
        from falcon_genome_tpu.io.sam import SamHeader, SamRecord

        header = SamHeader(contigs=[("c1", 5000), ("c2", 3000)])
        recs = []
        for i in range(50):
            seq = "".join(rng.choice(list("ACGT"), rng.integers(1, 80)))
            r = SamRecord(
                qname=f"q{i}", flag=int(rng.integers(0, 4096)),
                tid=int(rng.integers(-1, 2)), pos=int(rng.integers(0, 4000)),
                mapq=int(rng.integers(0, 61)),
                cigar=[(0, len(seq))], seq=seq,
                qual="".join(chr(33 + int(q))
                             for q in rng.integers(0, 42, len(seq))))
            r.set_tag("NM", "i", int(rng.integers(0, 5)))
            r.set_tag("RG", "Z", "rg0")
            if i % 3 == 0:
                r.set_tag("BQ", "B", ("C", [1, 2, 250]))
            if i % 7 == 0:
                r.set_tag("XF", "f", 1.5)
            recs.append(r)
        recs.append(SamRecord(qname="empty"))  # unmapped, no seq
        path = str(tmp_path / "t.bam")
        write_bam(path, header, recs, index=False)

        _, got = read_bam(path)               # native path
        with BamReader(path) as r:
            want = list(r)                     # python streaming path
        assert len(got) == len(want) == len(recs)
        for g, w in zip(got, want):
            assert g == w, (g, w)
            assert dict(g.tags) == dict(w.tags)


class TestAssembly:
    def test_matches_python(self, rng):
        """Native assembly must match the python reference haplotype-for-
        haplotype across SNV/indel/noisy regions."""
        import falcon_genome_tpu.io.native_ext as ne
        if not ne.available():
            import pytest
            pytest.skip("native fgio not built")
        from falcon_genome_tpu.models.assembly import (
            AssemblyParams, _assemble_region_py)

        params = AssemblyParams(min_edge_mult=1)
        for trial in range(12):
            ref = rng.integers(0, 4, 180).astype(np.uint8)
            alt = ref.copy()
            kind = trial % 4
            if kind == 0:
                alt[90] = (alt[90] + 1) % 4                     # SNV
            elif kind == 1:
                alt = np.concatenate([alt[:90], alt[93:]])       # del
            elif kind == 2:
                alt = np.concatenate(
                    [alt[:90], rng.integers(0, 4, 4).astype(np.uint8),
                     alt[90:]])                                  # ins
            reads = []
            for i in range(40):
                hap = ref if i % 2 else alt
                p = rng.integers(0, max(1, len(hap) - 60))
                r = hap[p:p + 60].copy()
                if trial >= 8:                                   # noise
                    q = rng.integers(0, len(r))
                    r[q] = (r[q] + 1) % 4
                reads.append(r)
            want = _assemble_region_py(ref, reads, params)
            got_haps, got_k, got_fb = ne.assemble_region(
                ref, reads, params.kmer_sizes, params.min_edge_mult,
                params.max_haplotypes)
            assert got_k == want.kmer_size
            assert got_fb == want.fallback
            assert len(got_haps) == len(want.haplotypes), trial
            for a, b in zip(got_haps, want.haplotypes):
                assert np.array_equal(a, b), trial


class TestMinimizersMT:
    def test_multithreaded_path_matches_python(self, rng):
        """Inputs over the MT threshold (4M k-mers) take the threaded
        hash+window path; output must stay bit-identical."""
        import falcon_genome_tpu.io.native_ext as ne
        if not ne.available():
            import pytest
            pytest.skip("native fgio not built")
        from falcon_genome_tpu.aligner import _minimizers_py
        G = (4 << 20) + 50_000
        codes = rng.integers(0, 4, G).astype(np.uint8)
        codes[G // 3:G // 3 + 25] = 4          # N runs near chunk seams
        codes[2 * G // 3] = 4
        nh, np_, ns = ne.minimizers(codes, 17, 7)
        ph, pp, ps = _minimizers_py(codes, 17, 7)
        assert np.array_equal(nh, ph)
        assert np.array_equal(np_, pp)
        assert np.array_equal(ns, ps)


class TestGatherVar:
    """fg_gather_var vs the numpy repeat/arange gather it replaces."""

    @pytest.mark.parametrize("dtype", [np.uint8, np.int32])
    def test_matches_numpy(self, dtype):
        rng = np.random.default_rng(9)
        n_rec = 500
        lens_all = rng.integers(0, 40, n_rec).astype(np.int64)
        offs_all = np.zeros(n_rec, np.int64)
        np.cumsum(lens_all[:-1], out=offs_all[1:])
        blob = rng.integers(0, 200, int(lens_all.sum())).astype(dtype)
        idx = rng.permutation(n_rec)[:300]

        lens = lens_all[idx]
        new_off = np.zeros(len(idx), np.int64)
        np.cumsum(lens[:-1], out=new_off[1:])
        total = int(lens.sum())
        got = native_ext.gather_var(blob, offs_all[idx], lens, new_off,
                                    total)
        assert got is not None
        src = (np.repeat(offs_all[idx], lens)
               + (np.arange(total) - np.repeat(new_off, lens)))
        np.testing.assert_array_equal(got, blob[src])

    def test_empty_and_zero_lens(self):
        blob = np.arange(10, dtype=np.uint8)
        got = native_ext.gather_var(blob, np.zeros(3, np.int64),
                                    np.zeros(3, np.int64),
                                    np.zeros(3, np.int64), 0)
        assert got is not None and len(got) == 0


class TestSeedAndChain:
    def test_matches_numpy_candidates(self, rng):
        from falcon_genome_tpu.aligner import (
            AlignerParams, IndexParams, MinimizerIndex, candidate_arrays)
        from falcon_genome_tpu.io.dna import revcomp_codes
        if native_ext.load() is None:
            pytest.skip("native ext unavailable")
        G, n, L = 200_000, 300, 120
        chrom = rng.integers(0, 4, G).astype(np.uint8)
        idx = MinimizerIndex([("c", chrom)], IndexParams(k=15, w=5))
        codes = np.full((n, L), 4, np.uint8)
        lens = np.full(n, L, np.int32)
        for i in range(n):
            p = int(rng.integers(0, G - L))
            r = chrom[p:p + L].copy()
            mut = rng.random(L) < 0.02
            r = np.where(mut, (r + 1) % 4, r).astype(np.uint8)
            if rng.random() < 0.5:
                r = revcomp_codes(r)
            if i % 17 == 0:             # some short reads
                lens[i] = 60
                codes[i, :60] = r[:60]
            else:
                codes[i] = r
        p = AlignerParams()
        nat = candidate_arrays(codes, lens, idx, p)
        # force the numpy path
        orig = native_ext.seed_and_chain
        try:
            native_ext.seed_and_chain = lambda *a, **k: None
            ref = candidate_arrays(codes, lens, idx, p)
        finally:
            native_ext.seed_and_chain = orig
        assert all(len(a) == len(b) for a, b in zip(nat, ref))
        for a, b in zip(nat, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
