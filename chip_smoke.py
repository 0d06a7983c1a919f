#!/usr/bin/env python
"""Start the germline pipeline on an NVIDIA GPU and check what comes out.

Run from the repository root on a machine with the card:

    python chip_smoke.py          # one card: kernels, then a germline run
    python chip_smoke.py --mesh   # four cards: the mesh path only

One card, two phases in one process:

  (a) kernels — each hand-written CUDA kernel (ops/dispatch.py says which
      run on the GPU) is compiled at production widths, its
      ``memory_analysis()`` printed, and its output compared with the
      float64 golden; the full Smith-Waterman (plain XLA) and its device
      traceback are compared with the golden alignment.
  (b) germline — a simulated 2x150 bp paired-end sample at ~30x over a
      4 Mb contig with planted heterozygous SNPs and indels runs through
      ``falcon_genome_tpu.cli germline`` (align -> markdup -> BQSR ->
      HaplotypeCaller -> VCF) at production batch and bucket shapes;
      per-stage wall times, reads/s and the calls against the planted
      truth are printed.

``--mesh`` (four cards) runs only the multi-card path users of a 4-GPU
host get by default: the same germline run under a 2x2 (data x region)
mesh with HaplotypeCaller compared record by record against one card on
the same recalibrated BAM, the sharded BQSR histogram against
``np.bincount``, and ``distributed_sort`` against ``np.sort``.

The script fails (non-zero exit, no result line) without a GPU, outside a
checkout, or when any check fails.  Its last line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""
from __future__ import annotations

import argparse
import gzip
import json
import logging
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / ".smoke"             # scratch inside the checkout

GENOME_BP = 3_100_000_000   # the human genome a user runs
CONTIG_BP = 4_000_000
DEPTH = 30
READ_LEN = 150
FRAG_MEAN, FRAG_SD = 350, 35
SNP_EVERY = 1000            # one het SNP per ~kb
INDEL_EVERY = 8000          # one het 1-4 bp indel per ~8 kb
SEQ_ERR = 0.002
SEED = 20261016


class CheckFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def card_line() -> str:
    """Card name and power limit, read by a child that stays off JAX."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(r.returncode == 0 and r.stdout.strip(),
          f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


# ---------------------------------------------------------------------------
# (a) kernels against the goldens
# ---------------------------------------------------------------------------

def _pairhmm_batch(rng, B=512, R=160, H=512, read_len=152):
    """Reads drawn from their haplotype (1% substitutions, some indels),
    a tenth scored against a sibling haplotype, a few unrelated pairs."""
    hlen = rng.integers(384, H + 1, B)
    haps = np.full((B, H), 4, np.uint8)
    reads = np.full((B, R), 4, np.uint8)
    for b in range(B):
        hap = rng.integers(0, 4, hlen[b]).astype(np.uint8)
        s = int(rng.integers(0, hlen[b] - read_len - 8))
        src = hap.copy()
        if rng.random() < 0.1:        # sibling haplotype: SNPs + a del
            for p in rng.integers(0, hlen[b], 3):
                src[p] = (src[p] + 1) % 4
            d = s + int(rng.integers(20, 120))
            src = np.concatenate([src[:d], src[d + 3:]])
        read = src[s:s + read_len].copy()
        if rng.random() < 0.02:       # unrelated pair
            read = rng.integers(0, 4, read_len).astype(np.uint8)
        mut = rng.random(read_len) < 0.01
        read[mut] = (read[mut] + 1) % 4
        haps[b, :hlen[b]] = hap
        reads[b, :read_len] = read
    quals = rng.integers(10, 41, (B, R)).astype(np.uint8)
    rlen = np.full(B, read_len, np.int32)
    return reads, quals, rlen, haps, hlen.astype(np.int32)


def _sw_batch(rng, B, R=160, W=256, read_len=150, win_len=214,
              off_target=0.05):
    """Aligner-shaped lanes: a read and a window of read_len + 2*32; a
    fraction ``off_target`` of the reads are unrelated to their window."""
    wins = np.full((B, W), 5, np.uint8)
    reads = np.full((B, R), 4, np.uint8)
    for b in range(B):
        win = rng.integers(0, 4, win_len).astype(np.uint8)
        s = int(rng.integers(0, win_len - read_len - 6))
        src = win[s:s + read_len + 6].copy()
        r = rng.random()
        if r < 0.15:                  # deletion in the read
            d = int(rng.integers(20, 120))
            src = np.concatenate([src[:d], src[d + int(rng.integers(1, 5)):]])
        elif r < 0.3:                 # insertion in the read
            d = int(rng.integers(20, 120))
            ins = rng.integers(0, 4, int(rng.integers(1, 5))).astype(np.uint8)
            src = np.concatenate([src[:d], ins, src[d:]])
        read = src[:read_len]
        if rng.random() < off_target:
            read = rng.integers(0, 4, read_len).astype(np.uint8)
        mut = rng.random(read_len) < 0.01
        read[mut] = (read[mut] + 1) % 4
        wins[b, :win_len] = win
        reads[b, :read_len] = read
    return (reads, np.full(B, read_len, np.int32), wins,
            np.full(B, win_len, np.int32))


def phase_kernels(jax, jnp) -> None:
    from falcon_genome_tpu.ops import dispatch, gpu_kernels
    from falcon_genome_tpu.ops.pairhmm import (
        _finish_logp, _pairhmm_jax, _phred_to_prob)
    from falcon_genome_tpu.ops.pairhmm_ref import pairhmm_logp_ref_batch
    from falcon_genome_tpu.ops.smith_waterman import (
        SWBucket, _sw_scan_core, sw_extend_batch)
    from falcon_genome_tpu.ops.sw_ref import (
        SWParams, sw_align_ref, sw_score_ref_batch)
    from falcon_genome_tpu.io.sam import cigar_to_str

    rng = np.random.default_rng(SEED)
    print(f"[kernels] GPU choice: {dispatch.GPU_CHOICE}", flush=True)

    # PairHMM, scalar transitions 45/45/10 as HaplotypeCaller passes them.
    # Tolerance in log10: 2e-3, 5e-3 for rescaled pairs (as the CPU tests);
    # log10/pow on the card may differ from the CPU in the last ulps.
    reads, quals, rlen, haps, hlen = _pairhmm_batch(rng)
    trans = dict(p_ins=10 ** -4.5, p_del=10 ** -4.5, p_cont=0.1)

    def phmm(read, q, rlen, hap, hlen):
        perr = _phred_to_prob(q)
        acc, shift = gpu_kernels.pairhmm_fwd(read, perr, rlen, hap, hlen,
                                             **trans)
        return _finish_logp(acc, shift), shift

    args = tuple(jnp.asarray(a) for a in (reads, quals, rlen, haps, hlen))
    if dispatch.GPU_CHOICE["pairhmm"] == dispatch.CUDA:
        compiled = jax.jit(phmm).lower(*args).compile()
        print(f"[kernels] pairhmm B={len(reads)} R={reads.shape[1]} "
              f"H={haps.shape[1]} memory_analysis: "
              f"{compiled.memory_analysis()}", flush=True)
        logp, shift = (np.asarray(x) for x in compiled(*args))
        want = pairhmm_logp_ref_batch(reads, quals, 45, 45, 10, rlen, haps,
                                      hlen)
        scan = np.asarray(_pairhmm_jax(
            args[0].T, args[1].T, jnp.uint8(45), jnp.uint8(45),
            jnp.uint8(10), args[2][None], args[4][None], args[3].T,
            R=reads.shape[1], H=haps.shape[1]))
        rescued = shift > 0
        fin = np.isfinite(logp)
        err = np.abs(np.where(fin, logp - want, 0.0))
        # the -inf guard: pairs whose mass leaves f32 even with rescaling
        # (the scan has the same guard); the goldens put them far below
        # any likelihood a caller keeps
        floored = ~fin
        print(f"[kernels] pairhmm vs f64 golden: max |err| "
              f"{err[~rescued].max():.3g} (tol 2e-3), rescaled pairs "
              f"{int(rescued.sum())} max |err| "
              f"{err[rescued].max() if rescued.any() else 0.0:.3g} "
              f"(tol 5e-3), floored {int(floored.sum())} "
              f"(golden max {want[floored].max() if floored.any() else 0:.1f})"
              f"; scan floored {int((~np.isfinite(scan)).sum())}",
              flush=True)
        check(err[~rescued].max() <= 2e-3, "pairhmm error above 2e-3")
        check(not rescued.any() or err[rescued].max() <= 5e-3,
              "rescaled pairhmm error above 5e-3")
        check(not floored.any() or want[floored].max() < -100,
              "pairhmm floored a pair the golden keeps above -100")

    # Smith-Waterman score-only at the aligner's bucket: exact.
    params = SWParams()
    sreads, srl, swins, swl = _sw_batch(rng, 1024)
    sargs = tuple(jnp.asarray(a) for a in (sreads, srl, swins, swl))
    if dispatch.GPU_CHOICE["sw_score"] == dispatch.CUDA:
        def swk(read, rl, win, wl):
            return gpu_kernels.sw_score(
                read, rl, win, wl, match=params.match,
                mismatch=params.mismatch, gap_open=params.gap_open,
                gap_ext=params.gap_ext)
        compiled = jax.jit(swk).lower(*sargs).compile()
        print(f"[kernels] sw_score B={len(sreads)} R={sreads.shape[1]} "
              f"W={swins.shape[1]} memory_analysis: "
              f"{compiled.memory_analysis()}", flush=True)
        got = np.asarray(compiled(*sargs))
        want = sw_score_ref_batch(sreads, srl, swins, swl, params)
        _, scan_best, _ = _sw_scan_core(
            sargs[0].T.astype(jnp.int32), sargs[1][None],
            sargs[2].T.astype(jnp.int32), sargs[3][None], params=params,
            R=sreads.shape[1], W=swins.shape[1])
        scan_best = np.asarray(scan_best)[0]
        print(f"[kernels] sw_score vs golden: {int((got != want).sum())} "
              f"of {len(got)} differ; vs scan: "
              f"{int((got != scan_best).sum())} differ", flush=True)
        check(np.array_equal(got, want), "sw_score differs from golden")
        check(np.array_equal(got, scan_best), "sw_score differs from scan")

    # Full Smith-Waterman (plain XLA) + device traceback: score, spans and
    # CIGAR equal to the golden alignment.  Lanes hold reads that belong to
    # their window: among several equally best cells the wavefront keeps
    # the first diagonal, the golden the first row, so a random read's
    # low-score ties may end at different cells.
    n = 48
    sreads, srl, swins, swl = _sw_batch(rng, n, off_target=0.0)
    res = sw_extend_batch(sreads, srl, swins, swl, params,
                          SWBucket(max_read_len=160, max_win_len=256))
    bad = 0
    for b in range(n):
        want = sw_align_ref(sreads[b, :srl[b]], swins[b, :swl[b]], params)
        got = res[b]
        if ((got.score, got.read_start, got.read_end, got.ref_start,
             got.ref_end, cigar_to_str(got.cigar))
                != (want.score, want.read_start, want.read_end,
                    want.ref_start, want.ref_end, cigar_to_str(want.cigar))):
            bad += 1
    print(f"[kernels] full SW + traceback vs golden: {bad} of {n} differ",
          flush=True)
    check(bad == 0, "full SW differs from golden")


# ---------------------------------------------------------------------------
# (b) germline run on a simulated sample
# ---------------------------------------------------------------------------

def simulate_sample(work: Path, rng) -> dict:
    """Reference contig, planted het SNPs/indels, 2x150 bp FASTQs."""
    from falcon_genome_tpu.io.dna import decode_seq
    from falcon_genome_tpu.io.fasta import write_fasta

    ref = rng.integers(0, 4, CONTIG_BP).astype(np.uint8)
    sites = np.sort(rng.choice(np.arange(1000, CONTIG_BP - 1000, 50),
                               CONTIG_BP // SNP_EVERY
                               + CONTIG_BP // INDEL_EVERY, replace=False))
    is_indel = np.zeros(len(sites), bool)
    is_indel[rng.choice(len(sites), CONTIG_BP // INDEL_EVERY,
                        replace=False)] = True
    # build the alternate haplotype left to right
    parts, last = [], 0
    snps, indels = [], []
    for p, ind in zip(sites.tolist(), is_indel.tolist()):
        parts.append(ref[last:p])
        if not ind:
            parts.append(np.array([(ref[p] + 1) % 4], np.uint8))
            snps.append(p)
            last = p + 1
        elif rng.random() < 0.5:      # deletion of ref[p:p+L]
            L = int(rng.integers(1, 5))
            indels.append(p)
            last = p + L
        else:                         # insertion before ref[p]
            L = int(rng.integers(1, 5))
            parts.append(rng.integers(0, 4, L).astype(np.uint8))
            indels.append(p)
            last = p
    parts.append(ref[last:])
    alt = np.concatenate(parts)

    n_pairs = CONTIG_BP * DEPTH // (2 * READ_LEN)
    on_alt = rng.random(n_pairs) < 0.5
    frag = np.clip(rng.normal(FRAG_MEAN, FRAG_SD, n_pairs).astype(np.int64),
                   READ_LEN, 2 * FRAG_MEAN)
    hap_len = np.where(on_alt, len(alt), len(ref))
    start = (rng.random(n_pairs) * (hap_len - frag)).astype(np.int64)
    cols = np.arange(READ_LEN)
    seq1 = np.where(on_alt[:, None], alt[np.minimum(start[:, None] + cols,
                                                    len(alt) - 1)],
                    ref[np.minimum(start[:, None] + cols, len(ref) - 1)])
    end = start + frag
    idx2 = end[:, None] - 1 - cols
    seq2 = np.where(on_alt[:, None], alt[np.minimum(idx2, len(alt) - 1)],
                    ref[np.minimum(idx2, len(ref) - 1)])
    seq2 = 3 - seq2                   # reverse complement of the 3' end
    for s in (seq1, seq2):
        err = rng.random(s.shape) < SEQ_ERR
        s[err] = (s[err] + rng.integers(1, 4, int(err.sum()))) % 4

    ascii_base = np.frombuffer(b"ACGT", np.uint8)
    width = 9                         # "@f%07d\n"-style fixed-width names
    rec = 2 + 7 + 1 + READ_LEN + 1 + 2 + READ_LEN + 1

    def write_fastq(path: Path, seqs: np.ndarray) -> None:
        buf = np.empty((n_pairs, rec), np.uint8)
        names = np.char.encode(np.char.mod("@f%07d\n", np.arange(n_pairs)))
        buf[:, :width + 1] = np.frombuffer(b"".join(names), np.uint8
                                           ).reshape(n_pairs, width + 1)
        o = width + 1
        buf[:, o:o + READ_LEN] = ascii_base[seqs]
        o += READ_LEN
        buf[:, o:o + 3] = np.frombuffer(b"\n+\n", np.uint8)
        o += 3
        buf[:, o:o + READ_LEN] = ord("I")
        buf[:, o + READ_LEN] = ord("\n")
        buf.tofile(path)

    work.mkdir(parents=True, exist_ok=True)
    fa = work / "ref.fa"
    write_fasta(str(fa), {"chr1": decode_seq(ref)})
    write_fastq(work / "r_1.fastq", seq1)
    write_fastq(work / "r_2.fastq", seq2)
    return {"ref": str(fa), "fq1": str(work / "r_1.fastq"),
            "fq2": str(work / "r_2.fastq"), "n_reads": 2 * n_pairs,
            "snps": np.array(snps), "indels": np.array(indels)}


def score_calls(vcf: str, sample: dict) -> dict:
    """Sensitivity and extra calls against the planted truth.  SNPs match
    by position; an indel matches an indel record within 10 bp (callers
    may shift an indel within a repeat)."""
    from falcon_genome_tpu.io.vcf import read_vcf

    _, recs = read_vcf(vcf)
    calls = [r for r in recs if not r.is_gvcf_block]
    snp_truth = set(sample["snps"].tolist())
    indel_truth = np.asarray(sample["indels"])
    found_snp, found_indel, extra = set(), set(), 0
    for r in calls:
        p = r.pos - 1
        if all(len(a) == len(r.ref) == 1 for a in r.alts):
            if p in snp_truth:
                found_snp.add(p)
                continue
        else:
            near = np.nonzero(np.abs(indel_truth - (p + 1)) <= 10)[0]
            if len(near):
                found_indel.update(near.tolist())
                continue
        extra += 1
    n_truth = len(snp_truth) + len(indel_truth)
    return {"snp_sensitivity": len(found_snp) / len(snp_truth),
            "indel_sensitivity": len(found_indel) / len(indel_truth),
            "sensitivity": (len(found_snp) + len(found_indel)) / n_truth,
            "extra_calls": extra, "truth": n_truth, "calls": len(calls)}


class StageClock(logging.Handler):
    """Per-stage wall times from the pipeline's own log records."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.marks: list[tuple[float, str]] = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("markdup"):          # markdup logs once, at its end
            self.marks.append((record.created, "markdup"))
        elif " finishes in " in msg:
            name = msg.split(" finishes in ")[0]
            if not name.endswith("] pipeline"):
                self.marks.append((record.created, name))


def run_germline(work: Path, sample: dict, extra: list[str] = ()) -> tuple:
    from falcon_genome_tpu import cli

    out = work / "out.vcf.gz"
    clock = StageClock()
    logging.getLogger("falcon_genome_tpu").addHandler(clock)
    t0 = time.perf_counter()
    t0_wall = time.time()
    rc = cli.main(["germline", "-r", sample["ref"], "--fastq1",
                   sample["fq1"], "--fastq2", sample["fq2"], "-o", str(out),
                   "--sample-id", "smoke", "--produce-vcf", "-f",
                   "-O", f"temp_dir={work / 'tmp'}",
                   "-O", f"log_dir={work / 'log'}", *extra])
    wall = time.perf_counter() - t0
    logging.getLogger("falcon_genome_tpu").removeHandler(clock)
    check(rc == 0, f"germline exited {rc}")
    stages, prev = [], t0_wall
    for t, name in clock.marks:
        stages.append((name, t - prev))
        prev = t
    return out, wall, stages


def phase_germline() -> dict:
    rng = np.random.default_rng(SEED)
    work = WORK / "germline"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    sample = simulate_sample(work, rng)
    print(f"[germline] simulated {CONTIG_BP / 1e6:.1f} Mb contig "
          f"({CONTIG_BP / GENOME_BP:.2%} of a {GENOME_BP / 1e9:.1f} Gb "
          f"genome), {sample['n_reads']} reads 2x{READ_LEN} at {DEPTH}x, "
          f"{len(sample['snps'])} SNPs + {len(sample['indels'])} indels "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    out, wall, stages = run_germline(work, sample)
    for name, dt in stages:
        print(f"[germline] stage {name}: {dt:.3f} s", flush=True)
    score = score_calls(str(out), sample)
    print(f"[germline] wall {wall:.3f} s, {sample['n_reads'] / wall:.1f} "
          f"reads/s end to end; {json.dumps(score)}", flush=True)
    check(score["snp_sensitivity"] >= 0.97, "SNP sensitivity below 0.97")
    check(score["indel_sensitivity"] >= 0.8, "indel sensitivity below 0.8")
    check(score["extra_calls"] <= 0.02 * score["truth"],
          "extra calls above 2% of the truth set")
    return sample


# ---------------------------------------------------------------------------
# --mesh: four cards
# ---------------------------------------------------------------------------

def _vcf_records(path: Path) -> list[str]:
    with gzip.open(path, "rt") as f:
        return [ln for ln in f if not ln.startswith("#")]


def phase_mesh(jax) -> None:
    from falcon_genome_tpu import stages
    from falcon_genome_tpu.bqsr import (accumulate_table,
                                        extract_covariates_columns)
    from falcon_genome_tpu.io.bam import read_bam_columns
    from falcon_genome_tpu.stages.common import load_fasta
    from falcon_genome_tpu.config import init as config_init
    from falcon_genome_tpu.parallel.mesh import (
        MeshSpec, make_mesh, set_active_mesh, use_mesh)
    from falcon_genome_tpu.parallel.sharded import distributed_sort

    devices = jax.devices()
    check(len(devices) == 4, f"--mesh needs 4 cards, found {len(devices)}")
    rng = np.random.default_rng(SEED)
    work = WORK / "mesh"
    shutil.rmtree(work, ignore_errors=True)
    sample = simulate_sample(work, rng)
    print(f"[mesh] simulated {CONTIG_BP / 1e6:.1f} Mb, {sample['n_reads']} "
          "reads", flush=True)

    # germline under a 2x2 (data x region) mesh: sharded PairHMM, psum BQSR
    out_mesh, wall, _ = run_germline(
        work, sample, ["-O", "tpu.mesh.data=2", "-O", "tpu.mesh.region=2"])
    print(f"[mesh] germline on 2x2 mesh: {wall:.3f} s, "
          f"{json.dumps(score_calls(str(out_mesh), sample))}", flush=True)

    # the same recalibrated BAM, HaplotypeCaller on one card
    conf = config_init()
    conf.set("temp_dir", str(work / "tmp"))
    recal = str(out_mesh) + ".work/recal"
    out_one = work / "one.vcf.gz"
    t0 = time.perf_counter()
    set_active_mesh(None)     # the process-wide mesh the runner threads read
    stages.run_htc(conf, sample["ref"], recal, str(out_one),
                   produce_vcf=True, sample="smoke", force=True)
    print(f"[mesh] htc on one card: {time.perf_counter() - t0:.3f} s",
          flush=True)
    a, b = _vcf_records(out_mesh), _vcf_records(out_one)
    print(f"[mesh] VCF records: mesh {len(a)}, one card {len(b)}, equal "
          f"{a == b}", flush=True)
    check(a == b, "mesh VCF differs from one-card VCF")

    # BQSR covariate histogram: psum over the mesh vs host bincount
    mesh = make_mesh(MeshSpec(data=2, region=2), devices)
    header, cols = read_bam_columns(str(out_mesh) + ".work/dedup.bam")
    fa = load_fasta(sample["ref"])
    ref_by_tid = {i: fa.contig_codes(name)
                  for i, (name, _) in enumerate(header.contigs)}
    cov = extract_covariates_columns(cols, ref_by_tid, None, {"rg0": 0})
    with use_mesh(None):
        host = accumulate_table(cov, ["rg0"])
    with use_mesh(mesh):
        dev = accumulate_table(cov, ["rg0"])
    same = all(np.array_equal(getattr(host, k), getattr(dev, k))
               for k in ("qual_obs", "qual_err", "cycle_obs", "cycle_err",
                         "ctx_obs", "ctx_err"))
    print(f"[mesh] BQSR tables over {len(cov['rg'])} bases: mesh == host "
          f"bincount: {same}", flush=True)
    check(same, "mesh BQSR tables differ from host bincount")

    # distributed sort over all four cards
    sort_mesh = make_mesh(MeshSpec(data=4, region=1), devices)
    keys = rng.integers(0, 1 << 62, sample["n_reads"]).astype(np.uint64)
    got = distributed_sort(sort_mesh, keys)
    ok = np.array_equal(got, np.sort(keys))
    print(f"[mesh] distributed_sort of {len(keys)} keys == np.sort: {ok}",
          flush=True)
    check(ok, "distributed_sort differs from np.sort")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", action="store_true",
                    help="four cards: run only the mesh phase")
    args = ap.parse_args()
    if not (ROOT / "falcon_genome_tpu").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import jax
    import jax.numpy as jnp
    import jaxlib

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    print(f"device: {dev.device_kind} x{len(devices)}; jax {jax.__version__}"
          f", jaxlib {jaxlib.__version__}", flush=True)
    try:
        print(f"card: {card_line()}", flush=True)
        from falcon_genome_tpu.io import native_ext
        check(native_ext.available(), "native/ did not build")
        print("native_ext: available", flush=True)
        t0 = time.perf_counter()
        if args.mesh:
            phase_mesh(jax)
        else:
            phase_kernels(jax, jnp)
            print(f"[kernels] done in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            phase_germline()
        print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
