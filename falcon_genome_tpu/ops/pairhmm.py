"""Batched PairHMM forward likelihood.

This replaces the reference's FPGA PairHMM service (Blaze NAM behind GATK
HaplotypeCaller/Mutect2 — SURVEY.md §2 row 25, src/workers/BlazeWorker.cpp):
instead of a background accelerator daemon fed over sockets, the likelihood
batch is an in-process computation over device arrays.

Two implementations of one recurrence, chosen by ``ops/dispatch.py``:

* ``_pairhmm_jax`` — the anti-diagonal wavefront as a ``lax.scan``: the
  M/I/D recurrences depend on (i-1,j-1), (i-1,j) and (i,j-1), so cells on
  an anti-diagonal d = i+j are independent; the wavefront is an (R, B)
  array (read position × pair) stepped over d = 1..R+H.  It takes any
  per-base transition planes and is the CPU path.
* ``gpu_kernels.pairhmm_fwd`` — the warp-strip CUDA kernel for the scalar
  transitions every caller passes (ins/del/gcp constant per batch): one
  warp per pair, read rows in registers in strips of 32.

Shared by both:

* **Length bucketing.** Reads pad to R, haplotypes to H (static shapes);
  per-pair read_len/hap_len masks handle raggedness.
* **f32 with exact per-pair power-of-2 rescaling.**  GATK runs f32 with
  initial condition 2^120 and falls back to f64 on underflow; here any
  pair whose live state has shrunk below 2^-60 is multiplied by 2^100
  (exact — the recurrence is linear) and the shift is kept in a per-pair
  exponent.  The scan checks every RESCALE_EVERY diagonals, the CUDA kernel
  at every 32-row strip boundary.  A pair whose whole column range exceeds
  f32 (a read that genuinely doesn't align to the hap) floors to the -inf
  guard — the pairs GATK routes to its f64 fallback, and which every caller
  here floors to a minimum likelihood anyway.

Result: log10 P(read|hap) per pair, matching the float64 golden model
(`pairhmm_ref.py`) to f32 tolerance.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from . import dispatch

LOG10_2 = math.log10(2.0)
LOG10_INITIAL = 120 * LOG10_2   # initial condition 2^120 (f32 headroom)
RESCALE_EVERY = 64
RESCALE_THRESH = 2.0 ** -60
RESCALE_FACTOR = 2.0 ** 100
RESCALE_SHIFT_LOG10 = 100 * LOG10_2

LANES = 128  # pair-count granularity of the padded batch


@dataclasses.dataclass(frozen=True)
class PairHMMParams:
    """Static bucket shape for one compiled variant."""
    max_read_len: int = 160   # multiple of 8
    max_hap_len: int = 512


def _phred_to_prob(q: jnp.ndarray) -> jnp.ndarray:
    return jnp.power(10.0, -q.astype(jnp.float32) / 10.0)


def _finish_logp(acc, shift):
    return jnp.where(
        acc > 0.0,
        jnp.log10(jnp.maximum(acc, jnp.finfo(jnp.float32).tiny))
        - shift - LOG10_INITIAL,
        -jnp.inf)


def _pairhmm_cuda(read_t, baseq_t, rlen_t, hap_t, hlen_t, *, R: int,
                  scalar_trans: tuple[int, int, int]):
    """Scalar-transition CUDA kernel on time-major (rows, B) inputs."""
    from . import gpu_kernels
    B = read_t.shape[1]
    p_err = jnp.broadcast_to(_phred_to_prob(baseq_t), (R, B))
    p_ins, p_del, p_cont = (
        float(np.power(np.float32(10.0), np.float32(-q) / np.float32(10.0)))
        for q in scalar_trans)
    acc, shift = gpu_kernels.pairhmm_fwd(
        read_t.T, p_err.T, rlen_t.reshape(B), hap_t.T, hlen_t.reshape(B),
        p_ins=p_ins, p_del=p_del, p_cont=p_cont)
    return _finish_logp(acc, shift)


@functools.partial(jax.jit, static_argnames=("R", "H"))
def _pairhmm_jax(read_codes, base_q, ins_q, del_q, gcp, rlen, hlen,
                 hap_codes, *, R: int, H: int):
    """Anti-diagonal wavefront as a lax.scan: the CPU path, and the GPU
    path for per-base transition planes.

    Quality inputs are phred int arrays OR pre-converted f32 probability
    arrays (float inputs pass through unchanged).
    """
    f32 = jnp.float32
    read_codes = read_codes.astype(jnp.int32)
    hap_codes = hap_codes.astype(jnp.int32)
    B = read_codes.shape[1]
    p_err = jnp.broadcast_to(_phred_to_prob(base_q), (R, B))
    p_ins = jnp.broadcast_to(_phred_to_prob(ins_q), (R, B))
    p_del = jnp.broadcast_to(_phred_to_prob(del_q), (R, B))
    p_cont = jnp.broadcast_to(_phred_to_prob(gcp), (R, B))
    rlen = rlen.astype(jnp.int32)
    hlen = hlen.astype(jnp.int32)
    a_mm = 1.0 - jnp.minimum(1.0, p_ins + p_del)
    a_im = 1.0 - p_cont
    rvec = jnp.arange(R, dtype=jnp.int32).reshape(R, 1)
    hlen_f = hlen.astype(f32)
    boundary0 = (f32(2.0) ** 120) / jnp.maximum(hlen_f, 1.0)
    zero_row = jnp.zeros((1, B), f32)
    zeros = jnp.zeros((R, B), f32)

    def shift(x, fill):
        return jnp.concatenate([fill, x[:-1]], axis=0)

    def step(carry, d):
        m1, i1, d1, m2, i2, d2, hapd, acc, sh, bound = carry
        new_hap = jax.lax.dynamic_slice(
            hap_codes, (jnp.clip(d - 2, 0, H - 1), 0), (1, B))
        hapd = shift(hapd, new_hap)
        jvec = d - rvec - 1
        live = (jvec >= 1).astype(f32)
        match = (read_codes == hapd) | (read_codes >= 4) | (hapd >= 4)
        prior = jnp.where(match, 1.0 - p_err, p_err / 3.0)
        m_new = prior * (shift(m2, zero_row) * a_mm
                         + (shift(i2, zero_row) + shift(d2, bound)) * a_im) * live
        i_new = (shift(m1, zero_row) * p_ins + shift(i1, zero_row) * p_cont) * live
        d_new = (m1 * p_del + d1 * p_cont) * live
        amask = ((rvec + 1 == rlen) & (jvec >= 1) & (jvec <= hlen)).astype(f32)
        acc = acc + jnp.sum((m_new + i_new) * amask, axis=0, keepdims=True)

        def rescale(args):
            m1, i1, d1, m2, i2, d2, acc, sh, bound = args
            m = jnp.maximum(
                jnp.max(jnp.abs(m1) + jnp.abs(i1) + jnp.abs(d1), 0, keepdims=True),
                jnp.max(jnp.abs(m2) + jnp.abs(i2) + jnp.abs(d2), 0, keepdims=True))
            need = (m > 0.0) & (m < RESCALE_THRESH)
            scale = jnp.where(need, f32(RESCALE_FACTOR), f32(1.0))
            sh = sh + jnp.where(need, f32(RESCALE_SHIFT_LOG10), f32(0.0))
            return (m1 * scale, i1 * scale, d1 * scale, m2 * scale,
                    i2 * scale, d2 * scale, acc * scale, sh, bound * scale)

        args = (m_new, i_new, d_new, m1, i1, d1, acc, sh, bound)
        m1, i1, d1, m2, i2, d2, acc, sh, bound = jax.lax.cond(
            d % RESCALE_EVERY == 0, rescale, lambda a: a, args)
        return (m1, i1, d1, m2, i2, d2, hapd, acc, sh, bound), None

    init = (zeros, zeros, zeros, zeros, zeros, zeros,
            jnp.zeros((R, B), jnp.int32), jnp.zeros((1, B), f32),
            jnp.zeros((1, B), f32), boundary0)
    (m1, i1, d1, m2, i2, d2, hapd, acc, sh, bound), _ = jax.lax.scan(
        step, init, jnp.arange(1, R + H + 1))
    return _finish_logp(acc, sh)[0]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# mesh-sharded dispatch: the SAME per-device body the single-device path
# runs, under shard_map over the pipeline's (data, region) mesh — multi-chip
# as a property of every caller stage, not a sidecar (the reference runs
# its whole pipeline under mpirun/ssh scale-out, BWAWorker.cpp:97-130)
# ---------------------------------------------------------------------------

_SHARDED_CACHE: dict = {}


def _local_pairhmm(read_t, baseq_t, insq_t, delq_t, gcp_t, rlen_t, hlen_t,
                   hap_t, *, R: int, H: int, impl: str,
                   scalar_trans: tuple[int, int, int] | None = None):
    """Per-device body (time-major (rows, B_local) arrays).

    ``scalar_trans`` = (ins_q, del_q, gcp) phreds marks constant
    transitions, which the CUDA kernel takes as launch constants; per-base
    transition planes always run the scan."""
    if impl == dispatch.CUDA and scalar_trans is not None:
        return _pairhmm_cuda(read_t, baseq_t, rlen_t, hap_t, hlen_t, R=R,
                             scalar_trans=scalar_trans)
    return _pairhmm_jax(read_t, baseq_t, insq_t, delq_t, gcp_t,
                        rlen_t, hlen_t, hap_t, R=R, H=H)


def _pairhmm_unpack(blob, R: int, H: int, flags: tuple[bool, ...],
                    scalars: tuple[int, ...]):
    """Split the fused uint8 input blob into the 8 kernel args.

    Layout (rows): R read codes, H hap codes, one R-row phred plane per
    flags[i]=True member of (base_q, ins_q, del_q, gcp) — scalars ride
    as compile-time constants instead — then 4 rows of LE length bytes.
    """
    off = 0
    read = blob[off:off + R]
    off += R
    hap = blob[off:off + H]
    off += H
    qs = []
    for f, s in zip(flags, scalars):
        if f:
            qs.append(blob[off:off + R])
            off += R
        else:
            qs.append(jnp.full((1, 1), s, jnp.uint8))
    lens = blob[off:off + 4].astype(jnp.int32)
    rlen = (lens[0] | (lens[1] << 8))[None, :]
    hlen = (lens[2] | (lens[3] << 8))[None, :]
    return read, qs[0], qs[1], qs[2], qs[3], rlen, hlen, hap


@functools.partial(jax.jit, static_argnames=("impl", "R", "H", "flags",
                                             "scalars"))
def _pairhmm_fused(blob, *, impl: str, R: int, H: int,
                   flags: tuple[bool, ...], scalars: tuple[int, ...]):
    """Single-transfer device entry: the whole batch ships as ONE uint8
    blob (see _pairhmm_unpack)."""
    read, baseq, insq, delq, gcpq, rlen, hlen, hap = _pairhmm_unpack(
        blob, R, H, flags, scalars)
    st = None if any(flags[1:]) else tuple(scalars[1:])
    return _local_pairhmm(read, baseq, insq, delq, gcpq, rlen, hlen, hap,
                          R=R, H=H, impl=impl, scalar_trans=st)


def _pairhmm_sharded_fused(mesh, impl: str, R: int, H: int,
                           flags: tuple[bool, ...],
                           scalars: tuple[int, ...]):
    """Fused-blob variant of the shard_map dispatch: the blob shards over
    lanes (axis 1) on every mesh axis; scalar quals are compile-time."""
    key = ("fused", mesh, impl, R, H, flags, scalars)
    fn = _SHARDED_CACHE.get(key)
    if fn is not None:
        return fn
    from jax.sharding import PartitionSpec as P
    axes = tuple(mesh.axis_names)

    def local(blob):
        read, baseq, insq, delq, gcpq, rlen, hlen, hap = _pairhmm_unpack(
            blob, R, H, flags, scalars)
        st = None if any(flags[1:]) else tuple(scalars[1:])
        return _local_pairhmm(read, baseq, insq, delq, gcpq, rlen, hlen,
                              hap, R=R, H=H, impl=impl, scalar_trans=st)

    fn = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(P(None, axes),), out_specs=P(axes),
        check_vma=False))
    _SHARDED_CACHE[key] = fn
    return fn


def pairhmm_logp(read_codes, base_q, ins_q, del_q, gcp, read_lens,
                 hap_codes, hap_lens,
                 params: PairHMMParams | None = None) -> jnp.ndarray:
    """log10 P(read|hap) for a batch of pairs.

    Args are batch-major numpy/JAX arrays: reads (B, R') uint8 codes and
    phred arrays, haps (B, H') codes, plus per-pair lengths. They are padded
    to the static bucket (params.max_read_len/max_hap_len), transposed to
    time-major, and batched to a power of two of at least 128 pairs.
    """
    params = params or PairHMMParams()
    MAX_LANES_PER_CALL = 8192
    if read_codes.shape[0] > MAX_LANES_PER_CALL:
        parts = []
        for s in range(0, read_codes.shape[0], MAX_LANES_PER_CALL):
            e = s + MAX_LANES_PER_CALL

            def cut(x):     # scalar qual planes pass through unsliced
                return x[s:e] if getattr(x, "ndim", 0) >= 1 else x

            parts.append(pairhmm_logp(
                read_codes[s:e], cut(base_q), cut(ins_q), cut(del_q),
                cut(gcp), read_lens[s:e], hap_codes[s:e], hap_lens[s:e],
                params))
        return jnp.concatenate(parts)
    B, Rin = read_codes.shape
    Hin = hap_codes.shape[1]
    R = _round_up(max(Rin, 8), 8)
    H = max(Hin, 8)
    if R > params.max_read_len:
        raise ValueError(f"read bucket {R} exceeds {params.max_read_len}")
    if Hin > params.max_hap_len:
        raise ValueError(f"hap bucket {Hin} exceeds {params.max_hap_len}")
    R = params.max_read_len
    H = params.max_hap_len
    from ..parallel.mesh import get_active_mesh
    mesh = get_active_mesh()
    nmesh = mesh.size if mesh is not None else 1
    # power-of-two lane bucket: bounds compile variants to ~log2 shapes;
    # under a mesh the unit is lanes × devices (each shard a full block)
    Bp = LANES * nmesh
    while Bp < B:
        Bp *= 2

    # fused single-transfer input blob (see _pairhmm_unpack for layout):
    # codes and phreds ship as uint8 (1/4 the bytes of int32), scalar
    # indel/gcp quals ride as compile-time constants, and everything
    # goes to the device in ONE contiguous buffer
    def is_scalar(x):
        return np.isscalar(x) or (isinstance(x, np.ndarray) and x.ndim == 0)

    quals = (base_q, ins_q, del_q, gcp)
    flags = tuple(not is_scalar(x) for x in quals)
    scalars = tuple(0 if f else int(x) for f, x in zip(flags, quals))
    rows = R + H + 4 + sum(flags) * R
    blob = np.empty((rows, Bp), np.uint8)

    def fill(off, x, nrows, fill_val):
        x = np.asarray(x)
        if x.dtype != np.uint8:
            x = x.astype(np.uint8)
        blob[off:off + nrows] = fill_val
        blob[off:off + x.shape[1], :B] = x.T
        return off + nrows

    off = fill(0, read_codes, R, 4)
    off = fill(off, hap_codes, H, 4)
    for f, x in zip(flags, quals):
        if f:
            off = fill(off, x, R, 0)
    blob[off:] = 0
    rl32 = np.asarray(read_lens, np.int32)
    hl32 = np.asarray(hap_lens, np.int32)
    # lengths ride as 16-bit LE bytes; wider values would wrap silently
    if (rl32.size and int(rl32.max()) >= 65536) or \
            (hl32.size and int(hl32.max()) >= 65536):
        raise ValueError("pairhmm_logp: read/hap lengths exceed 16-bit")
    blob[off, :B] = rl32 & 0xFF
    blob[off + 1, :B] = rl32 >> 8
    blob[off + 2, :B] = hl32 & 0xFF
    blob[off + 3, :B] = hl32 >> 8
    # padded lanes: length 1 keeps the kernel's masks well-defined
    blob[off, B:] = 1
    blob[off + 2, B:] = 1

    blob_d = jnp.asarray(blob)
    impl = dispatch.choose("pairhmm")
    if mesh is not None:
        logp = _pairhmm_sharded_fused(mesh, impl, R, H, flags,
                                      scalars)(blob_d)
    else:
        logp = _pairhmm_fused(blob_d, impl=impl, R=R, H=H,
                              flags=flags, scalars=scalars)
    return logp[:B]


# ---------------------------------------------------------------------------
# pair-indexed dispatch: unique reads/haps ship once, pairs expand on device
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=(
    "impl", "R", "H", "NRp", "NHp", "Bp", "scalars"))
def _pairhmm_pairs_fused(blob, *, impl: str, R: int, H: int,
                         NRp: int, NHp: int, Bp: int,
                         scalars: tuple[int, int, int]):
    """Unpack the pair-indexed blob (see pairhmm_logp_pairs), gather the
    (R, Bp)/(H, Bp) pair tiles on device, and run the kernel."""
    flat = blob.reshape(-1)
    o = 0
    read_tab = flat[o:o + NRp * R].reshape(NRp, R)
    o += NRp * R
    qual_tab = flat[o:o + NRp * R].reshape(NRp, R)
    o += NRp * R
    hap_tab = flat[o:o + NHp * H].reshape(NHp, H)
    o += NHp * H
    rlen_tab = (flat[o:o + NRp].astype(jnp.int32)
                | (flat[o + NRp:o + 2 * NRp].astype(jnp.int32) << 8))
    o += 2 * NRp
    hlen_tab = (flat[o:o + NHp].astype(jnp.int32)
                | (flat[o + NHp:o + 2 * NHp].astype(jnp.int32) << 8))
    o += 2 * NHp
    pr = (flat[o:o + Bp].astype(jnp.int32)
          | (flat[o + Bp:o + 2 * Bp].astype(jnp.int32) << 8))
    o += 2 * Bp
    ph = (flat[o:o + Bp].astype(jnp.int32)
          | (flat[o + Bp:o + 2 * Bp].astype(jnp.int32) << 8))

    read_t = jnp.take(read_tab, pr, axis=0).T      # (R, Bp)
    qual_t = jnp.take(qual_tab, pr, axis=0).T
    hap_t = jnp.take(hap_tab, ph, axis=0).T        # (H, Bp)
    rlen = jnp.take(rlen_tab, pr)[None, :]
    hlen = jnp.take(hlen_tab, ph)[None, :]
    insq = jnp.full((1, 1), scalars[0], jnp.uint8)
    delq = jnp.full((1, 1), scalars[1], jnp.uint8)
    gcpq = jnp.full((1, 1), scalars[2], jnp.uint8)
    return _local_pairhmm(read_t, qual_t, insq, delq, gcpq, rlen, hlen,
                          hap_t, R=R, H=H, impl=impl,
                          scalar_trans=tuple(int(s) for s in scalars))


def pairhmm_logp_pairs(reads, quals, read_lens, haps, hap_lens,
                       pair_read, pair_hap,
                       ins_q: int, del_q: int, gcp: int,
                       params: PairHMMParams | None = None) -> np.ndarray:
    """log10 P(read|hap) for pairs given as (read index, hap index).

    HaplotypeCaller batches are cross products (every read × every hap
    per region): shipping per-pair read/hap copies re-sends each read
    n_hap× and each hap n_read× from host to device.  Here the
    UNIQUE reads/quals/haps ship once in a single fused buffer with the
    per-pair (read, hap) index arrays, and the (R, B)/(H, B) pair tiles
    are gathered on device — ~5× fewer bytes for typical HTC shapes.

    reads (NR, R') u8 codes, quals (NR, R') u8 phreds, haps (NH, H') u8,
    read_lens (NR,), hap_lens (NH,), pair_read/pair_hap (B,) int;
    ins_q/del_q/gcp are scalars (compile-time).  B must be ≤ 8192 —
    callers chunk by region groups so each chunk's tables stay local.
    Under a multi-chip mesh this falls back to the sharded per-pair
    path (the index tables cannot shard over lanes).
    """
    params = params or PairHMMParams()
    B = len(pair_read)
    if B == 0:
        return np.zeros(0, np.float32)
    from ..parallel.mesh import get_active_mesh
    if get_active_mesh() is not None:
        pr = np.asarray(pair_read)
        ph = np.asarray(pair_hap)
        return np.asarray(pairhmm_logp(
            reads[pr], quals[pr], ins_q, del_q, gcp,
            np.asarray(read_lens)[pr], haps[ph],
            np.asarray(hap_lens)[ph], params))

    NR, Rin = reads.shape
    NH, Hin = haps.shape
    R = params.max_read_len
    H = params.max_hap_len
    if _round_up(max(Rin, 8), 8) > R or Hin > H:
        raise ValueError("input exceeds PairHMM bucket shape")

    def pow2(n, lo):
        p = lo
        while p < n:
            p *= 2
        return p

    NRp = pow2(NR, 8)
    NHp = pow2(NH, 8)
    Bp = pow2(B, LANES)
    if B > 8192:
        raise ValueError("pairhmm_logp_pairs: chunk pairs to <= 8192")
    # indices and lengths ride as 16-bit LE bytes — anything
    # wider would silently wrap to a wrong table row / length
    if NRp >= 65536 or NHp >= 65536:
        raise ValueError("pairhmm_logp_pairs: read/hap tables exceed "
                         "16-bit index range")

    def pad_tab(x, np_, cols, fill):
        x = np.asarray(x)
        if x.dtype != np.uint8:
            x = x.astype(np.uint8)
        out = np.full((np_, cols), fill, np.uint8)
        out[:x.shape[0], :x.shape[1]] = x
        return out.reshape(-1)

    def pad_lens16(x, np_):
        v = np.ones(np_, np.int32)
        v[:len(x)] = np.asarray(x, np.int32)
        return np.concatenate([(v & 0xFF).astype(np.uint8),
                               (v >> 8).astype(np.uint8)])

    def pad_idx16(x):
        v = np.zeros(Bp, np.int32)
        v[:B] = np.asarray(x, np.int32)
        return np.concatenate([(v & 0xFF).astype(np.uint8),
                               (v >> 8).astype(np.uint8)])

    flat = np.concatenate([
        pad_tab(reads, NRp, R, 4), pad_tab(quals, NRp, R, 0),
        pad_tab(haps, NHp, H, 4),
        pad_lens16(read_lens, NRp), pad_lens16(hap_lens, NHp),
        pad_idx16(pair_read), pad_idx16(pair_hap)])
    rows = (len(flat) + Bp - 1) // Bp
    blob = np.zeros(rows * Bp, np.uint8)
    blob[:len(flat)] = flat
    logp = _pairhmm_pairs_fused(
        jnp.asarray(blob.reshape(rows, Bp)),
        impl=dispatch.choose("pairhmm"), R=R, H=H,
        NRp=NRp, NHp=NHp, Bp=Bp,
        scalars=(int(ins_q), int(del_q), int(gcp)))
    return np.asarray(logp[:B])
