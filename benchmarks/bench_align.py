import time, numpy as np, sys
sys.path.insert(0, str(__import__('pathlib').Path(__file__).parent.parent))
from falcon_genome_tpu.aligner import AlignerEngine, AlignerParams, IndexParams, MinimizerIndex
from falcon_genome_tpu.io.dna import revcomp_codes

rng = np.random.default_rng(0)
genome_len = 1_000_000
chrom = rng.integers(0, 4, genome_len).astype(np.uint8)
t0 = time.perf_counter()
idx = MinimizerIndex([("chr1", chrom)], IndexParams(k=17, w=7))
print(f"index build 1Mb: {time.perf_counter()-t0:.2f}s  entries={len(idx.hashes)}")

n, L = 5000, 150
reads = np.zeros((n, L), np.uint8)
for i in range(n):
    p = rng.integers(0, genome_len - L)
    r = chrom[p:p+L].copy()
    mut = rng.random(L) < 0.01
    r = np.where(mut, (r + rng.integers(1,4,L)) % 4, r).astype(np.uint8)
    reads[i] = revcomp_codes(r) if rng.random() < 0.5 else r
lens = np.full(n, L, np.int32)

eng = AlignerEngine(idx, AlignerParams())
# warm up (compile SW kernel)
eng.align_batch(reads[:64], lens[:64])
eng.align_batch(reads, lens)  # warm all shapes
t0 = time.perf_counter()
res = eng.align_batch(reads, lens)
dt = time.perf_counter() - t0
mapped = sum(a.mapped for a in res)
print(f"align {n} reads: {dt:.2f}s -> {n/dt:.0f} reads/s  (mapped {mapped/n:.1%})")
