"""falcon_genome_tpu — a genomics variant-calling engine in JAX.

A from-scratch re-design of the capabilities of falcon-computing/falcon-genome
(``fcs-genome``) for accelerators driven from JAX; it runs on an NVIDIA GPU
and, for tests, on the CPU:

* the FPGA-accelerated inner loops of the reference (banded Smith-Waterman
  seed extension inside bwa-flow, PairHMM forward inside GATK
  HaplotypeCaller/Mutect2) are JAX wavefronts and CUDA kernels operating on
  batched, length-bucketed read/haplotype arrays in device memory;
* the reference's process-orchestration runtime (Executor/Stage/
  BackgroundExecutor forking external binaries — see
  /root/reference/src/Executor.cpp) is a JAX pipeline: stages are pure
  functions over device arrays, scaled over a ``jax.sharding.Mesh``;
* the CLI surface mirrors the reference's subcommands
  (``fcs-genome {align,markdup,bqsr,htc,mutect2,joint,depth,vcf_filter,
  germline,ug,indel,concat,conf}`` — /root/reference/src/main.cpp:17-41).

Package layout::

    config.py     3-tier config system            (ref: src/config.cpp)
    utils/        errors, fs helpers, timing, log (ref: src/common.cpp, LogUtils.cpp)
    io/           FASTA/FASTQ/SAM/BAM/VCF codecs, interval sharders
    ops/          DP kernels (PairHMM, Smith-Waterman), their goldens, and
                  the per-platform kernel choice (dispatch.py)
    stages/       align/markdup/bqsr/htc/mutect2/joint/depth/filter stage fns
    pipeline/     stage-graph runner: timing, fail-fast, artifact naming, resume
    parallel/     mesh construction, shardings, distributed init
    models/       genotyping models (germline diploid, somatic T/N, UG legacy)
    cli.py        subcommand dispatch
"""

__version__ = "0.1.0"


def compile_cache_dir(environ=None) -> str | None:
    """Where the persistent XLA compilation cache lives.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and is
    left to JAX (an empty value turns the cache off); None is returned and
    no directory is set in code.  Otherwise a fixed path inside the
    checkout, ``<repo>/.jax_cache`` — fixed, because the path is part of
    the cache key.
    """
    import os
    environ = os.environ if environ is None else environ
    if "JAX_COMPILATION_CACHE_DIR" in environ:
        return None
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".jax_cache")


def _enable_compile_cache() -> None:
    """Persistent XLA compilation cache, shared across processes: each CLI
    subcommand runs as its own process, and a repeat shape then loads from
    disk instead of compiling again."""
    cache_dir = compile_cache_dir()
    import jax
    if cache_dir is not None:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


_enable_compile_cache()
