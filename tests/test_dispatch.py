"""Kernel choice, the CUDA wrappers' layout, compile-cache placement and the
GPU-only entry points — everything around the CUDA kernels that runs on
the CPU.

The CUDA wrapper paths are driven end to end here by standing the NumPy
emulations of the kernels (tests/test_gpu_kernels.py) in for the FFI
calls through ``jax.pure_callback``.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from falcon_genome_tpu.ops import dispatch, gpu_kernels
from falcon_genome_tpu.ops.pairhmm import (PairHMMParams, pairhmm_logp,
                                           pairhmm_logp_pairs)
from falcon_genome_tpu.ops.pairhmm_ref import pairhmm_logp_ref_batch
from falcon_genome_tpu.ops.sw_ref import SWParams, sw_score_ref_batch

sys.path.insert(0, str(Path(__file__).parent))
from test_gpu_kernels import emulate_pairhmm, emulate_sw_score  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", sorted(dispatch.GPU_CHOICE))
@pytest.mark.parametrize("platform,want", [
    ("cpu", dispatch.XLA), ("gpu", "gpu-choice")])
def test_choose_by_platform(kernel, platform, want):
    want = dispatch.GPU_CHOICE[kernel] if want == "gpu-choice" else want
    assert dispatch.choose(kernel, platform) == want


@pytest.mark.parametrize("platform", ["tpu", "rocm", "METAL"])
def test_choose_rejects_other_platforms(platform):
    with pytest.raises(RuntimeError, match="no pairhmm implementation"):
        dispatch.choose("pairhmm", platform)


def test_choose_here_is_plain_xla():
    assert jax.default_backend() == "cpu"
    assert {dispatch.choose(k) for k in dispatch.GPU_CHOICE} == {
        dispatch.XLA}


def test_unknown_kernel_and_impl():
    with pytest.raises(KeyError):
        dispatch.choose("bogus", "cpu")
    with pytest.raises(ValueError):
        with dispatch.forced("pairhmm", "pallas"):
            pass


def test_forced_scopes_and_restores():
    with dispatch.forced("sw_score", dispatch.CUDA):
        assert dispatch.choose("sw_score", "cpu") == dispatch.CUDA
        with dispatch.forced("sw_score", dispatch.XLA):
            assert dispatch.choose("sw_score", "gpu") == dispatch.XLA
        assert dispatch.choose("sw_score", "cpu") == dispatch.CUDA
    assert dispatch.choose("sw_score", "cpu") == dispatch.XLA


# ---------------------------------------------------------------------------
# CUDA wrapper paths with the emulated kernels standing in
# ---------------------------------------------------------------------------

@pytest.fixture
def emulated_kernels(monkeypatch):
    """Replace the FFI calls with the NumPy emulations; record shapes."""
    seen = {"pairhmm": [], "sw_score": []}

    def pairhmm_fwd(read, perr, rlen, hap, hlen, *, p_ins, p_del, p_cont):
        seen["pairhmm"].append((read.shape, hap.shape, (p_ins, p_del,
                                                        p_cont)))
        B = read.shape[0]

        def host(read, perr, rlen, hap, hlen):
            acc, shift, _ = emulate_pairhmm(
                np.asarray(read), np.asarray(perr), np.asarray(rlen),
                np.asarray(hap), np.asarray(hlen), p_ins, p_del, p_cont)
            return acc, shift
        out = (jax.ShapeDtypeStruct((B,), jnp.float32),) * 2
        return jax.pure_callback(host, out, read.astype(jnp.uint8), perr,
                                 rlen.astype(jnp.int32),
                                 hap.astype(jnp.uint8),
                                 hlen.astype(jnp.int32))

    def sw_score(read, rlen, win, wlen, *, match, mismatch, gap_open,
                 gap_ext):
        seen["sw_score"].append((read.shape, win.shape))
        p = SWParams(match, mismatch, gap_open, gap_ext)

        def host(read, rlen, win, wlen):
            return emulate_sw_score(np.asarray(read), np.asarray(rlen),
                                    np.asarray(win), np.asarray(wlen), p)
        return jax.pure_callback(
            host, jax.ShapeDtypeStruct((read.shape[0],), jnp.int32),
            read.astype(jnp.uint8), rlen.astype(jnp.int32),
            win.astype(jnp.uint8), wlen.astype(jnp.int32))

    monkeypatch.setattr(gpu_kernels, "pairhmm_fwd", pairhmm_fwd)
    monkeypatch.setattr(gpu_kernels, "sw_score", sw_score)
    jax.clear_caches()
    yield seen
    jax.clear_caches()


def _tables(rng, NR, NH, R, H):
    haps = rng.integers(0, 4, (NH, H)).astype(np.uint8)
    reads = np.full((NR, R), 4, np.uint8)
    rl = rng.integers(R // 2, R + 1, NR).astype(np.int32)
    for i in range(NR):
        h = haps[i % NH]
        s = rng.integers(0, H - rl[i] + 1)
        reads[i, :rl[i]] = h[s:s + rl[i]]
    mut = (rng.random(reads.shape) < 0.03) & (reads < 4)
    reads = np.where(mut, (reads + 1) % 4, reads).astype(np.uint8)
    quals = rng.integers(15, 40, (NR, R)).astype(np.uint8)
    hl = rng.integers(H - 10, H + 1, NH).astype(np.int32)
    return reads, quals, rl, haps, hl


def test_pairhmm_pairs_cuda_path(emulated_kernels, rng):
    """pairhmm_logp_pairs through the CUDA wrapper: pair-major (B, R)
    inputs, power-of-two lane padding, scalar transitions as constants."""
    NR, NH, R, H = 9, 3, 40, 48
    reads, quals, rl, haps, hl = _tables(rng, NR, NH, R, H)
    pr = np.repeat(np.arange(NR), NH)
    ph = np.tile(np.arange(NH), NR)
    params = PairHMMParams(max_read_len=40, max_hap_len=64)
    with dispatch.forced("pairhmm", dispatch.CUDA):
        got = pairhmm_logp_pairs(reads, quals, rl, haps, hl, pr, ph,
                                 45, 45, 10, params=params)
    (rshape, hshape, trans), = emulated_kernels["pairhmm"]
    assert rshape == (128, 40) and hshape == (128, 64)
    np.testing.assert_allclose(trans, (10 ** -4.5, 10 ** -4.5, 0.1),
                               rtol=1e-6)
    want = pairhmm_logp_ref_batch(reads[pr], quals[pr], 45, 45, 10, rl[pr],
                                  haps[ph], hl[ph])
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def test_pairhmm_per_base_transitions_stay_on_scan(emulated_kernels, rng):
    """Per-base indel quals have no CUDA kernel: the scan runs them even
    when the GPU choice is CUDA; scalar quals reach the kernel."""
    B, R, H = 5, 24, 40
    reads, quals, rl, haps, hl = _tables(rng, B, B, R, H)
    iq = rng.integers(30, 50, (B, R)).astype(np.uint8)
    gcp = np.full((B, R), 10, np.uint8)
    params = PairHMMParams(max_read_len=24, max_hap_len=40)
    with dispatch.forced("pairhmm", dispatch.CUDA):
        per_base = np.asarray(pairhmm_logp(reads, quals, iq, iq, gcp, rl,
                                           haps, hl, params=params))
        assert emulated_kernels["pairhmm"] == []
        scalar = np.asarray(pairhmm_logp(reads, quals, 45, 45, 10, rl,
                                         haps, hl, params=params))
        assert len(emulated_kernels["pairhmm"]) == 1
    np.testing.assert_allclose(
        per_base, pairhmm_logp_ref_batch(reads, quals, iq, iq, gcp, rl,
                                         haps, hl), rtol=0, atol=2e-3)
    np.testing.assert_allclose(
        scalar, pairhmm_logp_ref_batch(reads, quals, 45, 45, 10, rl, haps,
                                       hl), rtol=0, atol=2e-3)


@pytest.mark.parametrize("B,lanes", [(1, 128), (128, 128), (129, 256),
                                     (700, 1024)])
def test_pairhmm_lane_bucket(monkeypatch, B, lanes):
    """Batches pad to a power of two of at least 128 pairs; lengths of the
    padded lanes are 1."""
    from falcon_genome_tpu.ops import pairhmm as ph
    seen = {}
    real = ph._pairhmm_fused

    def spy(blob, **kw):
        seen["blob"] = np.asarray(blob)
        return real(blob, **kw)
    monkeypatch.setattr(ph, "_pairhmm_fused", spy)
    R, H = 8, 16
    rng = np.random.default_rng(B)
    reads = rng.integers(0, 4, (B, R)).astype(np.uint8)
    haps = rng.integers(0, 4, (B, H)).astype(np.uint8)
    q = np.full((B, R), 30, np.uint8)
    out = pairhmm_logp(reads, q, 45, 45, 10, np.full(B, R, np.int32), haps,
                       np.full(B, H, np.int32),
                       params=PairHMMParams(max_read_len=R, max_hap_len=H))
    blob = seen["blob"]
    assert out.shape == (B,)
    assert blob.shape == (R + H + R + 4, lanes)   # one qual plane: base_q
    lens = blob[-4:]
    assert (lens[0, B:] == 1).all() and (lens[2, B:] == 1).all()
    assert (lens[0, :B] == R).all() and (lens[2, :B] == H).all()


def test_sw_score_cuda_path(emulated_kernels, rng):
    """sw_score_gather through the CUDA wrapper: windows gathered from the
    resident genome, reverse-strand lanes complemented, exact scores."""
    from falcon_genome_tpu.io.dna import revcomp_codes
    from falcon_genome_tpu.ops.smith_waterman import (
        SWBucket, device_genome, device_reads, sw_score_gather)
    G, n, L, W = 5000, 12, 48, 96
    genome = rng.integers(0, 4, G).astype(np.uint8)
    starts = rng.integers(0, G - W, n).astype(np.int32)
    is_rev = (np.arange(n) % 2).astype(np.int32)
    reads = np.full((n, 64), 4, np.uint8)
    for i in range(n):
        seg = genome[starts[i] + 20:starts[i] + 20 + L].copy()
        seg[rng.random(L) < 0.05] = 0
        reads[i, :L] = revcomp_codes(seg) if is_rev[i] else seg
    rl = np.full(n, L, np.int32)
    wl = np.full(n, W, np.int32)
    bucket = SWBucket(max_read_len=64, max_win_len=128)
    args = (device_reads(reads), np.arange(n), is_rev, rl,
            device_genome(genome), starts, wl, SWParams(), bucket)
    with dispatch.forced("sw_score", dispatch.CUDA):
        got = sw_score_gather(*args)
    assert emulated_kernels["sw_score"] == [((128, 64), (128, 128))]
    plain = sw_score_gather(*args)
    oriented = np.stack([revcomp_codes(reads[i, :L]) if is_rev[i]
                         else reads[i, :L] for i in range(n)])
    wins = np.stack([genome[s:s + W] for s in starts])
    want = sw_score_ref_batch(oriented, rl, wins, wl)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain, want)


def test_aligner_pair_path_cuda_matches_plain(emulated_kernels, rng):
    """The aligner's fused pair dispatch gives the same alignments with the
    score pass on the CUDA path as on the scan."""
    from falcon_genome_tpu.aligner import (AlignerEngine, AlignerParams,
                                           IndexParams, MinimizerIndex)
    from falcon_genome_tpu.io.dna import revcomp_codes
    from falcon_genome_tpu.ops.smith_waterman import SWBucket
    G, B1, L, frag = 20000, 24, 100, 250
    chrom = rng.integers(0, 4, G).astype(np.uint8)
    idx = MinimizerIndex([("chr1", chrom)], IndexParams(k=15, w=5))
    c1 = np.zeros((B1, L), np.uint8)
    c2 = np.zeros((B1, L), np.uint8)
    for i in range(B1):
        p = int(rng.integers(0, G - frag))
        c1[i] = chrom[p:p + L]
        c2[i] = revcomp_codes(chrom[p + frag - L:p + frag])
    lens = np.full(B1, L, np.int32)
    eng = AlignerEngine(idx, AlignerParams(),
                        bucket=SWBucket(max_read_len=128, max_win_len=256))
    with dispatch.forced("sw_score", dispatch.CUDA):
        a1, a2 = eng.align_pair_batch(c1, lens, c2, lens)
    assert len(emulated_kernels["sw_score"]) == 1
    b1, b2 = eng.align_pair_batch(c1, lens, c2, lens)
    for x, y in zip(a1 + a2, b1 + b2):
        assert (x.mapped, x.pos, x.is_rev, x.cigar, x.score) == \
            (y.mapped, y.pos, y.is_rev, y.cigar, y.score)
    assert sum(a.mapped for a in a1 + a2) == 2 * B1


# ---------------------------------------------------------------------------
# compile cache, multi-process bring-up, GPU-only entry points
# ---------------------------------------------------------------------------

def test_compile_cache_dir_fixed_in_checkout():
    from falcon_genome_tpu import compile_cache_dir
    assert compile_cache_dir({}) == str(ROOT / ".jax_cache")
    assert compile_cache_dir({"HOME": "/elsewhere"}) == str(
        ROOT / ".jax_cache")


@pytest.mark.parametrize("value", ["/some/cache", ""])
def test_compile_cache_dir_left_to_jax_when_set(value):
    from falcon_genome_tpu import compile_cache_dir
    assert compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": value}) is None


@pytest.mark.parametrize("set_var", [False, True])
def test_compile_cache_on_import(tmp_path, set_var):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    want = str(ROOT / ".jax_cache")
    if set_var:
        want = str(tmp_path / "c")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    r = subprocess.run(
        [sys.executable, "-c", "import falcon_genome_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == want


@pytest.mark.parametrize("env_ids,pid,want", [
    (None, 0, [0]), (None, 3, [3]), ("2", 1, None)])
def test_distributed_initialize_one_card_per_process(monkeypatch, env_ids,
                                                     pid, want):
    from falcon_genome_tpu.parallel import mesh
    calls = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: calls.append(kw))
    if env_ids is None:
        monkeypatch.delenv("JAX_LOCAL_DEVICE_IDS", raising=False)
    else:
        monkeypatch.setenv("JAX_LOCAL_DEVICE_IDS", env_ids)
    mesh.distributed_initialize("localhost:1", 4, pid)
    assert calls[0]["local_device_ids"] == want
    mesh.distributed_initialize(None, 1, 0)       # single process: no-op
    assert len(calls) == 1


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_entry_points_refuse_cpu(script):
    r = _run([str(ROOT / script)], str(ROOT))
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout and "{" not in r.stdout


def test_chip_smoke_needs_the_checkout(tmp_path):
    import shutil
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert r.stdout == ""
