"""Device mesh construction.

The reference's host topology (``hosts`` config list, mpirun hostfiles with
slots — src/config.cpp:209-220, src/workers/CombineGVCFsWorker.cpp:227-246)
maps to a 2-axis logical mesh:

* ``data``   — read-batch data parallelism (the reference's per-host MPI
  rank for bwa-flow, P5);
* ``region`` — genome-region parallelism (the reference's ncontigs process
  scatter, P1).

On one host every card reaches every other at the same rate, so the mesh
follows the algorithm alone; multi-host puts ``data`` across hosts and
``region`` within a host.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading

import jax
import numpy as np
from jax.sharding import Mesh

log = logging.getLogger("falcon_genome_tpu")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    data: int = -1     # -1: all remaining devices
    region: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        region = max(1, self.region)
        data = self.data if self.data > 0 else n_devices // region
        if data * region != n_devices:
            raise ValueError(
                f"mesh {data}x{region} != device count {n_devices}")
        return data, region


def make_mesh(spec: MeshSpec = MeshSpec(),
              devices: list | None = None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    data, region = spec.resolve(len(devices))
    dev_array = np.asarray(devices).reshape(data, region)
    return Mesh(dev_array, axis_names=("data", "region"))


def distributed_initialize(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Multi-process bring-up (replaces mpirun: jax.distributed.initialize).

    Each process takes one GPU of the host: process i gets card i, unless
    ``JAX_LOCAL_DEVICE_IDS`` names the cards (JAX reads it).  A JAX
    process reserves most of the memory of every card it sees, so
    processes must not share cards; CPU processes ignore the card ids.
    No-op when single-process (one process drives every card of a host
    through the mesh).
    """
    if num_processes and num_processes > 1:
        import os
        ids = (None if os.environ.get("JAX_LOCAL_DEVICE_IDS")
               else [process_id or 0])
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=ids)


# ---------------------------------------------------------------------------
# active mesh: the pipeline-wide device mesh the compute kernels dispatch
# through (the analog of the reference running its whole pipeline
# under mpirun/ssh scale-out — src/workers/BWAWorker.cpp:97-130,
# src/Executor.cpp:231-267 — instead of per-demo wiring)
# ---------------------------------------------------------------------------

_state = threading.local()
_GLOBAL_MESH: Mesh | None = None    # set once by the CLI; threads inherit
_UNSET = object()


def set_active_mesh(mesh: Mesh | None) -> None:
    """Install ``mesh`` as the process-wide compute mesh (CLI bring-up)."""
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh


def get_active_mesh() -> Mesh | None:
    """The mesh kernels should shard over (None = single device)."""
    mesh = getattr(_state, "mesh", _UNSET)
    return _GLOBAL_MESH if mesh is _UNSET else mesh


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None):
    """Scoped (thread-local) mesh override, for tests and nested stages;
    ``use_mesh(None)`` forces the single-device path."""
    prev = getattr(_state, "mesh", _UNSET)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        if prev is _UNSET:
            del _state.mesh
        else:
            _state.mesh = prev


def mesh_from_conf(conf, devices: list | None = None) -> Mesh | None:
    """Build the configured mesh (``tpu.mesh.data`` × ``tpu.mesh.region``).

    Returns None when the resolved mesh is a single device — stages then
    take the plain single-chip path.  ``tpu.mesh.data = -1`` means "all
    devices not taken by region", so on a multi-chip host the default
    config scales out automatically (the reference needs an explicit
    ``hosts`` list; a host's cards are always visible).
    """
    devices = devices if devices is not None else jax.devices()
    region = max(1, int(conf.get("tpu.mesh.region")))
    data = int(conf.get("tpu.mesh.data"))
    if data <= 0:
        data = max(1, len(devices) // region)
    if data * region <= 1:
        return None
    if data * region > len(devices):
        raise ValueError(
            f"tpu.mesh {data}x{region} exceeds {len(devices)} device(s)")
    return make_mesh(MeshSpec(data=data, region=region),
                     devices[:data * region])


def process_info() -> tuple[int, int]:
    """(process_index, process_count) — (0, 1) when not distributed."""
    try:
        import jax
        return jax.process_index(), jax.process_count()
    except Exception:
        return 0, 1


def is_primary() -> bool:
    """True on the process that performs final gathers/merges."""
    return process_info()[0] == 0


def sync_processes(tag: str) -> None:
    """Cross-process barrier (no-op single-process).

    The reference's analog is the Executor joining its per-host task
    set before the gather worker runs (src/Executor.cpp:231-267)."""
    if process_info()[1] <= 1:
        return
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices(tag)


def initialize_from_conf(conf) -> Mesh | None:
    """CLI bring-up: multi-process init (if configured) + active mesh.

    The reference's equivalent is Executor scale-out mode + mpirun
    hostfiles; here ``tpu.dist.*`` (set per-process by the launcher) feeds
    jax.distributed.initialize, and the resolved (data, region) mesh is
    installed process-wide so every stage's kernel batches shard over it.
    """
    nproc = int(conf.get("tpu.dist.num_processes") or 0)
    if nproc > 1:
        distributed_initialize(
            coordinator=conf.get("tpu.dist.coordinator") or None,
            num_processes=nproc,
            process_id=int(conf.get("tpu.dist.process_id") or 0))
    mesh = mesh_from_conf(conf)
    set_active_mesh(mesh)
    if mesh is not None:
        log.info("device mesh: data=%d region=%d over %d %s device(s)",
                 mesh.shape["data"], mesh.shape["region"], mesh.size,
                 mesh.devices.flat[0].platform)
    return mesh
