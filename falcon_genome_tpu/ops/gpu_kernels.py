"""JAX bindings of the CUDA kernels in ``native/dp_kernels.cu``.

The shared library is built from the repository's sources on first use
(``native/build_cuda.sh``, nvcc for sm_90a) into ``native/build/``, loaded
with ctypes and registered as XLA FFI targets.  These functions are called
inside jitted code at trace time; ``ops/dispatch.py`` decides when.

Inputs are pair-major, (B, R) and (B, H|W): one warp reads one pair's rows.
The kernels have no interpret mode; their CPU stand-ins are the plain
``lax`` wavefronts, and the strip tiling is emulated in NumPy by the tests.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
_SRC = _ROOT / "native" / "dp_kernels.cu"
_SO = _ROOT / "native" / "build" / "libfgdp.so"
_TARGETS = {"fg_pairhmm_fwd": "FgPairHmmFwd", "fg_sw_score": "FgSwScore"}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build() -> Path:
    """Compile the library if it is missing or older than its source."""
    if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
        r = subprocess.run(
            ["sh", str(_ROOT / "native" / "build_cuda.sh")],
            capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHON": sys.executable})
        if r.returncode != 0:
            raise RuntimeError(
                f"native/build_cuda.sh failed ({r.returncode}):\n"
                f"{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
    return _SO


def _register() -> None:
    global _lib
    with _lock:
        if _lib is not None:
            return
        lib = ctypes.cdll.LoadLibrary(str(build()))
        for target, symbol in _TARGETS.items():
            jax.ffi.register_ffi_target(
                target, jax.ffi.pycapsule(getattr(lib, symbol)),
                platform="CUDA")
        _lib = lib


def pairhmm_fwd(read, perr, rlen, hap, hlen, *, p_ins: float, p_del: float,
                p_cont: float):
    """Scalar-transition PairHMM forward.

    read (B, R) u8 codes, perr (B, R) f32 error probabilities, rlen (B,)
    i32, hap (B, H) u8, hlen (B,) i32.  Returns (acc, shift), both (B,)
    f32: the final-row mass on the 2^120 scale and the log10 of the
    rescaling applied.  The transition probabilities are launch constants.
    """
    _register()
    B = read.shape[0]
    f32 = np.float32
    out = (jax.ShapeDtypeStruct((B,), jnp.float32),) * 2
    return jax.ffi.ffi_call("fg_pairhmm_fwd", out)(
        read.astype(jnp.uint8), perr.astype(jnp.float32),
        rlen.astype(jnp.int32), hap.astype(jnp.uint8),
        hlen.astype(jnp.int32),
        a_mm=f32(1.0 - min(1.0, f32(p_ins) + f32(p_del))),
        a_im=f32(1.0 - f32(p_cont)), p_ins=f32(p_ins), p_del=f32(p_del),
        p_cont=f32(p_cont))


def sw_score(read, rlen, win, wlen, *, match: int, mismatch: int,
             gap_open: int, gap_ext: int):
    """Best local affine score per pair: read (B, R) u8, rlen (B,) i32,
    win (B, W) u8, wlen (B,) i32 -> (B,) i32."""
    _register()
    B = read.shape[0]
    i32 = np.int32
    return jax.ffi.ffi_call(
        "fg_sw_score", jax.ShapeDtypeStruct((B,), jnp.int32))(
        read.astype(jnp.uint8), rlen.astype(jnp.int32),
        win.astype(jnp.uint8), wlen.astype(jnp.int32),
        match=i32(match), mismatch=i32(mismatch),
        go=i32(gap_open + gap_ext), ge=i32(gap_ext))
