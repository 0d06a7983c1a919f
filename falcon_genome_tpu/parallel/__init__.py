"""Multi-chip parallelism: mesh construction, sharded compute steps.

Replacement for the reference's scale-out machinery (SURVEY.md
§2.3-2.4): mpirun/ssh/hostfiles become a `jax.sharding.Mesh`; per-contig
process scatter (P1) becomes region sharding; per-host read scatter
(P2/P5) becomes data sharding; MPI allreduce/gather becomes psum/gather
collectives compiled by XLA (NCCL between GPUs).
"""
from .mesh import MeshSpec, make_mesh
from .sharded import (
    sharded_pairhmm_step,
    sharded_bqsr_histogram,
    germline_train_step,
)

__all__ = [
    "MeshSpec", "make_mesh",
    "sharded_pairhmm_step", "sharded_bqsr_histogram", "germline_train_step",
]
