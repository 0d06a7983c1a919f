#!/bin/sh
# Build the GPU kernels (dp_kernels.cu) into build/libfgdp.so for Hopper
# (sm_90a).  Needs nvcc and JAX's FFI headers; run on the machine with the
# card.  ops/gpu_kernels.py runs this on first use.  Compile to a temp file
# and rename, as build.sh does.
set -e
cd "$(dirname "$0")"
NVCC="${NVCC:-nvcc}"
command -v "$NVCC" >/dev/null 2>&1 || NVCC=/usr/local/cuda/bin/nvcc
INC="$("${PYTHON:-python3}" -c 'import jax.ffi; print(jax.ffi.include_dir())')"
mkdir -p build
"$NVCC" -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
    -Xcompiler -fPIC -I"$INC" dp_kernels.cu -o "build/.libfgdp.so.tmp.$$"
mv "build/.libfgdp.so.tmp.$$" build/libfgdp.so
echo "built native/build/libfgdp.so"
