"""The one place that decides which implementation runs each DP kernel.

Every caller of PairHMM and Smith-Waterman goes through ``choose``; no
other module looks at the platform.

* ``cpu``: the plain ``lax`` wavefronts (``_pairhmm_jax``,
  ``_sw_scan_core``), which the tests run;
* ``gpu``: the implementation that measured faster on the card, end to end
  through its caller (PERF.md, "Findings"): ``CUDA`` for a hand-written
  kernel in ``native/dp_kernels.cu``, ``XLA`` for the plain version;
* any other platform is an error — there is no silent fallback.

``forced`` pins a kernel to one implementation for a scope; the benchmark
and ``chip_smoke.py`` use it to time and check both on the same card.
"""
from __future__ import annotations

import contextlib

import jax

XLA = "xla"    # plain jax.numpy / lax, compiled by XLA for the platform
CUDA = "cuda"  # hand-written CUDA kernel called through jax.ffi

# GPU implementation of each kernel (timings: PERF.md).  Full
# Smith-Waterman with traceback pointers has no entry: it is plain XLA on
# every platform.
GPU_CHOICE = {
    "pairhmm": CUDA,    # scalar-transition PairHMM forward
    "sw_score": CUDA,   # score-only Smith-Waterman
}

_forced: dict[str, str] = {}


def choose(kernel: str, platform: str | None = None) -> str:
    """Implementation of ``kernel`` on ``platform`` (default: JAX's)."""
    if kernel not in GPU_CHOICE:
        raise KeyError(f"unknown kernel {kernel!r}")
    if kernel in _forced:
        return _forced[kernel]
    platform = platform or jax.default_backend()
    if platform == "cpu":
        return XLA
    if platform == "gpu":
        return GPU_CHOICE[kernel]
    raise RuntimeError(
        f"no {kernel} implementation for platform {platform!r} "
        "(supported: cpu, gpu)")


@contextlib.contextmanager
def forced(kernel: str, impl: str):
    """Run ``kernel`` as ``impl`` (XLA or CUDA) inside the scope."""
    if kernel not in GPU_CHOICE:
        raise KeyError(f"unknown kernel {kernel!r}")
    if impl not in (XLA, CUDA):
        raise ValueError(f"unknown implementation {impl!r}")
    prev = _forced.get(kernel)
    _forced[kernel] = impl
    try:
        yield
    finally:
        if prev is None:
            del _forced[kernel]
        else:
            _forced[kernel] = prev
