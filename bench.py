#!/usr/bin/env python
"""Kernel and engine timings on one GPU, each DP kernel both ways.

For each kernel that ``ops/dispatch.py`` can run as a hand-written CUDA
kernel or as the plain ``lax`` wavefront, time both on the same card at
the production shapes — the kernel alone, and end to end through its
caller — so the choice in ``dispatch.GPU_CHOICE`` rests on a measurement:

  pairhmm     the scalar-transition PairHMM at HaplotypeCaller's bucket
              (8192 pairs, reads 152 in a 160 bucket, haplotypes 384);
              caller: ``pairhmm_logp_pairs`` and
              ``HaplotypeCaller.call_interval`` over simulated regions
  sw_score    score-only Smith-Waterman at the aligner's 160x256 bucket
              (32768 candidate lanes); caller: the aligner's fused pair
              dispatch, 4096 read pairs against a 4 Mb genome

plus the long-read engine with the chosen kernels.  Methodology: a kernel
runs N_INNER times inside one jitted loop with a data dependency between
iterations; every timing ends in ``block_until_ready`` or a host copy, and
the best of several runs is kept after a warm-up that compiles every shape.

Fails without a GPU.  Prints the card's name and power limit, then one
JSON line: {"device": ..., "card": ..., "results": {...}}.
"""
import json
import subprocess
import sys
import time

import numpy as np

N_INNER = 10
B_PHMM, R_REAL, H_REAL, R_BUCKET, H_BUCKET = 8192, 152, 384, 160, 384
B_SW, RL_SW, WL_SW, R_SW, W_SW = 32768, 150, 214, 160, 256


def _best(fn, n=3):
    fn()                                    # compile + warm
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _timed_loop(jax, loop, args):
    """Best per-iteration seconds of a jitted fori_loop."""
    return _best(lambda: jax.block_until_ready(loop(*args))) / N_INNER


def _both(kernel, fn):
    """fn() under each implementation -> {"cuda": s, "xla": s}."""
    from falcon_genome_tpu.ops import dispatch
    out = {}
    for impl in (dispatch.CUDA, dispatch.XLA):
        with dispatch.forced(kernel, impl):
            out[impl] = fn()
    return out


def _pairhmm_tables(rng, n):
    reads = np.full((n, R_BUCKET), 4, np.uint8)
    haps = rng.integers(0, 4, (n, H_BUCKET)).astype(np.uint8)
    for b in range(n):
        s = rng.integers(0, H_REAL - R_REAL + 1)
        reads[b, :R_REAL] = haps[b, s:s + R_REAL]
    mut = rng.random(reads.shape) < 0.01
    reads = np.where(mut & (reads < 4), (reads + 1) % 4, reads)
    quals = np.full((n, R_BUCKET), 30, np.uint8)
    return (reads.astype(np.uint8), quals, np.full(n, R_REAL, np.int32),
            haps, np.full(n, H_REAL, np.int32))


def bench_pairhmm_kernel(jax, jnp, rng):
    """Per-call seconds of the device body at HTC's bucket, both ways."""
    from falcon_genome_tpu.ops import dispatch
    from falcon_genome_tpu.ops.pairhmm import _local_pairhmm

    reads, quals, rl, haps, hl = _pairhmm_tables(rng, B_PHMM)
    args = (jnp.asarray(reads.T), jnp.asarray(quals.T),
            jnp.asarray(rl[None]), jnp.asarray(haps.T),
            jnp.asarray(hl[None]))
    q = jnp.full((1, 1), 45, jnp.uint8)

    def run():
        impl = dispatch.choose("pairhmm")

        @jax.jit
        def loop(read, qual, rlen, hap, hlen):
            def body(_, acc):
                r2 = jnp.where(acc[0] > 1e30, read + 1, read)
                return acc + _local_pairhmm(
                    r2, qual, q, q, q, rlen, hlen, hap, R=R_BUCKET,
                    H=H_BUCKET, impl=impl, scalar_trans=(45, 45, 10))
            return jax.lax.fori_loop(0, N_INNER, body,
                                     jnp.zeros((B_PHMM,), jnp.float32))
        return _timed_loop(jax, loop, args)

    secs = _both("pairhmm", run)
    cells = B_PHMM * R_REAL * H_REAL
    return {k: {"s_per_call": v, "gcups": cells / v / 1e9}
            for k, v in secs.items()}


def bench_pairhmm_caller(rng):
    """pairhmm_logp_pairs: host tables in, log-likelihoods out."""
    from falcon_genome_tpu.ops.pairhmm import (PairHMMParams,
                                               pairhmm_logp_pairs)
    NR, NH = 2048, 4
    reads, quals, rl, _, _ = _pairhmm_tables(rng, NR)
    haps = rng.integers(0, 4, (NH, H_BUCKET)).astype(np.uint8)
    hl = np.full(NH, H_REAL, np.int32)
    pr = np.repeat(np.arange(NR), NH)
    ph = np.tile(np.arange(NH), NR)
    params = PairHMMParams(max_read_len=R_BUCKET, max_hap_len=H_BUCKET)

    def run():
        return _best(lambda: pairhmm_logp_pairs(
            reads, quals, rl, haps, hl, pr, ph, 45, 45, 10, params=params))
    return _both("pairhmm", run)


def bench_htc_regions(rng):
    """HaplotypeCaller.call_interval over a 200 kb simulated interval with
    het SNPs every kb: assembly, hap-to-ref SW and the PairHMM batch."""
    from falcon_genome_tpu.io.dna import decode_seq
    from falcon_genome_tpu.io.sam import SamRecord, cigar_from_str
    from falcon_genome_tpu.models.haplotypecaller import (HaplotypeCaller,
                                                          HTCParams)
    G, L, depth = 200_000, 150, 30
    ref = rng.integers(0, 4, G).astype(np.uint8)
    alt = ref.copy()
    alt[np.arange(500, G - 500, 1000)] = (alt[np.arange(500, G - 500, 1000)]
                                          + 1) % 4
    n = G * depth // L
    starts = np.sort(rng.integers(0, G - L, n))
    recs = []
    for i, s in enumerate(starts.tolist()):
        seq = (alt if i % 2 else ref)[s:s + L]
        recs.append(SamRecord(f"r{i}", 0, 0, s, 60, cigar_from_str(f"{L}M"),
                              seq=decode_seq(seq), qual="?" * L))
    hc = HaplotypeCaller(HTCParams())

    def run():
        return _best(lambda: hc.call_interval(recs, ref, "chr1", 0, G), n=2)
    return _both("pairhmm", run)


def bench_sw_score_kernel(jax, jnp, rng):
    """Per-call seconds of the score-only pass at the aligner's bucket."""
    from falcon_genome_tpu.ops.smith_waterman import _sw_score_lanes
    from falcon_genome_tpu.ops.sw_ref import SWParams
    from falcon_genome_tpu.ops import dispatch

    win = np.full((W_SW, B_SW), 5, np.int32)
    win[:WL_SW] = rng.integers(0, 4, (WL_SW, B_SW))
    read = np.full((R_SW, B_SW), 4, np.int32)
    for b in range(0, B_SW):
        s = rng.integers(0, WL_SW - RL_SW + 1)
        read[:RL_SW, b] = win[s:s + RL_SW, b]
    mut = rng.random((RL_SW, B_SW)) < 0.01
    read[:RL_SW] = np.where(mut, (read[:RL_SW] + 1) % 4, read[:RL_SW])
    args = tuple(jnp.asarray(a) for a in (
        read, np.full((1, B_SW), RL_SW, np.int32), win,
        np.full((1, B_SW), WL_SW, np.int32)))

    def run():
        impl = dispatch.choose("sw_score")

        @jax.jit
        def loop(read, rlen, win, wlen):
            def body(_, acc):
                r2 = jnp.where(acc[0] > 10 ** 8, read + 1, read)
                return acc + _sw_score_lanes(
                    r2, rlen, win, wlen, params=SWParams(), R=R_SW, W=W_SW,
                    impl=impl)
            return jax.lax.fori_loop(0, N_INNER, body,
                                     jnp.zeros((B_SW,), jnp.int32))
        return _timed_loop(jax, loop, args)

    secs = _both("sw_score", run)
    cells = B_SW * RL_SW * WL_SW
    return {k: {"s_per_call": v, "gcups": cells / v / 1e9}
            for k, v in secs.items()}


def bench_align_pair(rng):
    """The aligner's production pair path: 4096 FR pairs vs a 4 Mb genome
    (seeding and chaining in threaded C++, one device dispatch per
    batch).  Returns reads/s per implementation and the mapped fraction."""
    from falcon_genome_tpu.aligner import (
        AlignerEngine, AlignerParams, IndexParams, MinimizerIndex)
    from falcon_genome_tpu.io.dna import revcomp_codes

    G, B1, L, frag = 4_000_000, 4096, 150, 350
    chrom = rng.integers(0, 4, G).astype(np.uint8)
    idx = MinimizerIndex([("chr1", chrom)], IndexParams(k=17, w=7))
    c1 = np.zeros((B1, L), np.uint8)
    c2 = np.zeros((B1, L), np.uint8)
    for i in range(B1):
        p = int(rng.integers(0, G - frag))
        r1 = chrom[p:p + L].copy()
        r2 = revcomp_codes(chrom[p + frag - L:p + frag].copy())
        for r in (r1, r2):
            mut = rng.random(L) < 0.005
            r[mut] = (r[mut] + 1) % 4
        c1[i], c2[i] = r1, r2
    lens = np.full(B1, L, np.int32)
    eng = AlignerEngine(idx, AlignerParams())
    mapped = {}

    def run():
        def once():
            h = eng.align_pair_dispatch(c1, lens, c2, lens)
            a, b = eng.align_pair_collect(h)
            mapped["frac"] = (int(a.mapped.sum()) + int(b.mapped.sum())) \
                / (2 * B1)
        return 2 * B1 / _best(once)
    rps = _both("sw_score", run)
    return {"reads_per_s": rps, "mapped_frac": mapped["frac"]}


def bench_longread(rng):
    """Long-read alignment (Mbp/s): 128 x 10 kb reads at 5% error against
    a 1 Mb reference."""
    from falcon_genome_tpu.aligner import IndexParams, MinimizerIndex
    from falcon_genome_tpu.longread import LongReadAligner, LongReadParams

    G, n_reads, read_len = 1_000_000, 128, 10_000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    lp = LongReadParams(index=IndexParams(k=19, w=10, max_hits=256))
    eng = LongReadAligner(MinimizerIndex([("chr1", genome)], lp.index), lp)
    reads = []
    for _ in range(n_reads):
        p = int(rng.integers(0, G - read_len))
        r = genome[p:p + read_len].copy()
        err = rng.random(read_len) < 0.05
        sub = rng.random(read_len) < 0.6
        r[err & sub] = (r[err & sub] + 1) % 4
        reads.append(r[~(err & ~sub)])
    res = []
    secs = _best(lambda: res.append(eng.align_batch(reads)))
    if sum(a.mapped for a in res[-1]) < n_reads * 0.9:
        raise RuntimeError("longread mapped fraction below 0.9")
    return sum(len(r) for r in reads) / secs / 1e6


def main() -> int:
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    rng = np.random.default_rng(0)
    results = {}
    for name, fn in (
            ("pairhmm_kernel", lambda: bench_pairhmm_kernel(jax, jnp, rng)),
            ("pairhmm_logp_pairs_s", lambda: bench_pairhmm_caller(rng)),
            ("htc_interval_s", lambda: bench_htc_regions(rng)),
            ("sw_score_kernel", lambda: bench_sw_score_kernel(jax, jnp,
                                                              rng)),
            ("align_pair", lambda: bench_align_pair(rng)),
            ("longread_mbp_per_s", lambda: bench_longread(rng))):
        t0 = time.perf_counter()
        results[name] = fn()
        print(f"# {name}: {results[name]} ({time.perf_counter() - t0:.1f} s"
              " with compiles)", flush=True)
    print(json.dumps({
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
