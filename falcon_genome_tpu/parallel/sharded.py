"""Sharded device steps: the multi-chip compute path.

The full "germline device step" — PairHMM likelihoods for a sharded batch
of read×haplotype pairs plus the BQSR covariate-histogram reduction — jitted
over a (data, region) mesh.  Sharding layout:

* pair batch (lane dim B) sharded over ``data`` × ``region`` — every chip
  works an independent slice of read×hap pairs (the reference's P1×P2/P5
  axes fused);
* the covariate histogram is psum-reduced to a replicated table (the
  reference's BQSRGatherWorker table merge as a collective);
* per-pair log-likelihoods stay sharded (they are consumed shard-locally
  by genotyping).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..bqsr import MAX_CYCLE, MAX_QUAL, N_CONTEXT
from ..ops import dispatch
from ..ops.pairhmm import _local_pairhmm


def sharded_pairhmm_step(mesh: Mesh, R: int, H: int):
    """The production per-device body under shard_map; batch lanes shard
    over the fused (data, region) mesh.  Per-device work is the SAME code
    the single-device path runs (ops/pairhmm.py::_local_pairhmm)."""
    impl = dispatch.choose("pairhmm")
    spec = P(None, ("data", "region"))  # (rows, B) — shard lanes

    def local(read_codes, base_q, ins_q, del_q, gcp, rlen, hlen, hap_codes):
        return _local_pairhmm(read_codes, base_q, ins_q, del_q, gcp,
                              rlen, hlen, hap_codes, R=R, H=H, impl=impl)

    return jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(spec,) * 8,
        out_specs=P(("data", "region")), check_vma=False))


def _histogram_local(rg, qual, cycle, context, is_error, weight, nrg):
    """Scatter-add covariate histograms for one device's slice.

    Counts are int32 (weight and is_error are 0/1), so the sums are exact
    up to 2^31 per bin; float32 sums stop being exact past 2^24."""
    i32 = jnp.int32
    weight = weight.astype(i32)
    errw = weight * is_error.astype(i32)
    qual = jnp.minimum(qual, MAX_QUAL - 1)    # top bin, as the host path
    flat = (rg * MAX_QUAL + qual) * MAX_CYCLE + cycle
    obs = jnp.zeros(nrg * MAX_QUAL * MAX_CYCLE, i32).at[flat].add(weight)
    err = jnp.zeros(nrg * MAX_QUAL * MAX_CYCLE, i32).at[flat].add(errw)
    ctx_flat = (rg * MAX_QUAL + qual) * N_CONTEXT + context
    ctx_obs = jnp.zeros(nrg * MAX_QUAL * N_CONTEXT, i32).at[ctx_flat].add(
        weight)
    ctx_err = jnp.zeros(nrg * MAX_QUAL * N_CONTEXT, i32).at[ctx_flat].add(
        errw)
    return (obs.reshape(nrg, MAX_QUAL, MAX_CYCLE),
            err.reshape(nrg, MAX_QUAL, MAX_CYCLE),
            ctx_obs.reshape(nrg, MAX_QUAL, N_CONTEXT),
            ctx_err.reshape(nrg, MAX_QUAL, N_CONTEXT))


def sharded_bqsr_histogram(mesh: Mesh, nrg: int = 1):
    """BQSR covariate histogram with a cross-chip psum reduction.

    Inputs are flat covariate arrays sharded on the fused (data, region)
    axis plus a per-element weight (0 for padding); the output tables are
    replicated — an AllReduce across the devices, the BQSRGatherWorker
    table merge (src/workers/BQSRWorker.cpp:111-150).
    """
    flat_spec = P(("data", "region"))

    def local(rg, qual, cycle, context, is_error, weight):
        tables = _histogram_local(rg, qual, cycle, context, is_error,
                                  weight, nrg)
        return tuple(jax.lax.psum(t, ("data", "region")) for t in tables)

    return jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(flat_spec,) * 6,
        out_specs=(P(), P(), P(), P()), check_vma=False))


def germline_train_step(mesh: Mesh, R: int, H: int, nrg: int = 1):
    """The full multi-chip device step of the germline pipeline:

    sharded PairHMM likelihoods (the production kernel) + replicated BQSR
    histogram — one jitted shard_map over the mesh, exercising both the
    sharded compute path and the collectives.
    """
    impl = dispatch.choose("pairhmm")
    batch_spec = P(None, ("data", "region"))
    flat_spec = P(("data", "region"))

    def local(read_codes, base_q, ins_q, del_q, gcp, rlen, hlen, hap_codes,
              rg, qual, cycle, context, is_error):
        logp = _local_pairhmm(read_codes, base_q, ins_q, del_q, gcp,
                              rlen, hlen, hap_codes, R=R, H=H, impl=impl)
        flat = (rg * MAX_QUAL + qual) * MAX_CYCLE + cycle
        obs = jnp.zeros(nrg * MAX_QUAL * MAX_CYCLE).at[flat].add(1.0)
        hist = jax.lax.psum(obs.reshape(nrg, MAX_QUAL, MAX_CYCLE),
                            ("data", "region"))
        return logp, hist

    return jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(batch_spec,) * 8 + (flat_spec,) * 5,
        out_specs=(P(("data", "region")), P()), check_vma=False))


def make_example_batch(B: int, R: int, H: int, n_cov: int, seed: int = 0):
    """Tiny example inputs for the sharded step (time-major layout)."""
    rng = np.random.default_rng(seed)
    read = rng.integers(0, 4, (R, B)).astype(np.int32)
    hap = rng.integers(0, 4, (H, B)).astype(np.int32)
    q = np.full((R, B), 30, np.int32)
    gcp = np.full((R, B), 10, np.int32)
    rlen = np.full((1, B), R, np.int32)
    hlen = np.full((1, B), H, np.int32)
    cov_rg = np.zeros(n_cov, np.int32)
    cov_q = rng.integers(0, MAX_QUAL, n_cov).astype(np.int32)
    cov_cyc = rng.integers(0, MAX_CYCLE, n_cov).astype(np.int32)
    cov_ctx = rng.integers(0, N_CONTEXT, n_cov).astype(np.int32)
    cov_err = rng.random(n_cov).astype(np.float32) < 0.01
    return (read, q, q, q, gcp, rlen, hlen, hap,
            cov_rg, cov_q, cov_cyc, cov_ctx,
            cov_err.astype(np.float32))


# ---------------------------------------------------------------------------
# distributed sample-sort (P2 at scale: the reference's bucket-BAM sort/
# merge tree — SambambaWorker SORT/MERGE over part-%06d buckets — as a
# device-mesh collective instead of a filesystem merge)
# ---------------------------------------------------------------------------

# Exchange padding value: sorts after (or ties with) every legitimate key,
# so taking the first `nvalid` entries of a device's sorted run is exact even
# when legitimate keys equal the pad value.  Validity is tracked by COUNT
# (an all_to_all of per-bucket counts), never by comparing against this
# value — a key of 0xFFFF…F is a legal input.
SORT_PAD = np.uint64(0xFFFFFFFFFFFFFFFF)
SORT_SENTINEL = SORT_PAD  # backwards-compat alias

_SORT_STEP_CACHE: dict = {}


def distributed_sort_step(mesh: Mesh, n_local: int, axis_name: str = "data",
                          capacity: int | None = None):
    """Compile (and cache) a distributed sample-sort over one mesh axis.

    Input: (nd * n_local,) uint64 keys, sharded over ``axis_name`` (each
    device holds n_local).  Callers embed the payload in the key's low
    bits (coordinate sort packs ``tid:8 | pos:32 | row:24``).

    Sample-sort across the devices: local sort → all_gather regular samples →
    global splitters → static-capacity bucket exchange via all_to_all →
    local merge.  Returns per-device sorted runs (pad-filled past the
    valid count), the per-device valid count (from a counts exchange, not
    a pad-value scan), and the global max bucket count (host retries with
    ``capacity = gmax`` when it exceeds the compiled capacity).
    """
    nd = mesh.shape[axis_name]
    C = capacity if capacity is not None else int(np.ceil(n_local / nd * 2))
    cache_key = (mesh, n_local, axis_name, C)
    cached = _SORT_STEP_CACHE.get(cache_key)
    if cached is not None:
        return cached
    OS = 8                                   # oversampling per device

    def local(keys):
        keys = jnp.sort(keys.reshape(-1))    # (n_local,)
        idxs = jnp.linspace(0, n_local - 1, nd * OS).astype(jnp.int32)
        samples = keys[idxs]
        all_s = jnp.sort(jax.lax.all_gather(samples, axis_name).reshape(-1))
        splits = all_s[jnp.arange(1, nd) * (nd * OS)]          # (nd-1,)
        cuts = jnp.searchsorted(keys, splits).astype(jnp.int32)
        lo = jnp.concatenate([jnp.zeros(1, jnp.int32), cuts])
        hi = jnp.concatenate([cuts, jnp.full(1, n_local, jnp.int32)])
        counts = hi - lo                                       # (nd,)
        gmax = jax.lax.pmax(jnp.max(counts), axis_name)
        gi = jnp.clip(lo[:, None] + jnp.arange(C)[None, :], 0, n_local - 1)
        send = jnp.where(jnp.arange(C)[None, :] < counts[:, None],
                         keys[gi], jnp.uint64(SORT_PAD))
        recv = jax.lax.all_to_all(send, axis_name, split_axis=0,
                                  concat_axis=0, tiled=True)    # (nd, C)
        # exact validity: row i of the counts exchange = how many keys
        # device i actually sent here (clipped to the compiled capacity —
        # past it the exchange truncated and the host retries anyway)
        recv_counts = jax.lax.all_to_all(
            jnp.minimum(counts, C), axis_name,
            split_axis=0, concat_axis=0, tiled=True)            # (nd,)
        merged = jnp.sort(recv.reshape(-1))                     # (nd*C,)
        nvalid = jnp.sum(recv_counts).astype(jnp.int32)
        return merged, nvalid.reshape(1), gmax.reshape(1)

    spec = P(axis_name)
    fn = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(spec,),
        out_specs=(spec, spec, spec)))
    _SORT_STEP_CACHE[cache_key] = fn
    return fn


def distributed_sort(mesh: Mesh, keys: np.ndarray,
                     axis_name: str = "data") -> np.ndarray:
    """Host wrapper: globally sort uint64 keys over the mesh axis.

    Pads to the device count, runs the sample-sort step, trims by count.
    A skewed bucket beyond the compiled exchange capacity triggers ONE
    retry compiled at exactly the observed max bucket size (the step
    reports the global max, so the retry cannot overflow again)."""
    nd = mesh.shape[axis_name]
    n = len(keys)
    n_local = int(np.ceil(n / nd))
    padded = np.full(nd * n_local, SORT_PAD, np.uint64)
    padded[:n] = keys
    # 64-bit keys need x64 tracing (JAX otherwise demotes uint64→uint32,
    # silently mangling coordinates); scoped to this step only
    with jax.enable_x64(True):
        step = distributed_sort_step(mesh, n_local, axis_name)
        merged, nvalid, gmax = step(jnp.asarray(padded))
        cap = int(np.ceil(n_local / nd * 2))
        observed = int(np.asarray(gmax).max())
        if observed > cap:
            step = distributed_sort_step(mesh, n_local, axis_name,
                                         capacity=observed)
            merged, nvalid, _ = step(jnp.asarray(padded))
    merged = np.asarray(merged).reshape(nd, -1)
    nvalid = np.asarray(nvalid)
    out = np.concatenate([merged[d, :nvalid[d]] for d in range(nd)])
    # host pads are SORT_PAD (the max value): they occupy the global tail,
    # so the first n entries are exactly the sorted input multiset
    return out[:n]


def mesh_coordinate_order(tid: np.ndarray, pos: np.ndarray,
                          mesh: Mesh, axis_name: str = "data"
                          ) -> np.ndarray | None:
    """Coordinate argsort over the device mesh: the bucket-BAM sort/merge
    tree (SambambaWorker SORT over part-%06d shards) as a collective.

    Packs ``tid:8 | pos:32 | row:24`` into uint64 keys and sample-sorts
    them over the mesh; the low 24 bits come back as the permutation.
    Returns None when the inputs don't fit the packing (caller falls back
    to the host lexsort): >16M rows per call, >255 contigs, or positions
    ≥ 2^32.  Stable (row index breaks ties in input order), matching
    np.lexsort."""
    n = len(pos)
    if n == 0:          # empty shard: nothing to sample-sort
        return np.zeros(0, np.int64)
    if n >= (1 << 24) or int(tid.max(initial=0)) >= 0xFF:
        return None
    keys = ((tid.astype(np.uint64) << np.uint64(56))
            | (pos.astype(np.uint64) << np.uint64(24))
            | np.arange(n, dtype=np.uint64))
    out = distributed_sort(mesh, keys, axis_name)
    return (out & np.uint64(0xFFFFFF)).astype(np.int64)
