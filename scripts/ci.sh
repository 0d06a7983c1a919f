#!/bin/bash
# CI entry point: one command reproduces the full gate suite from a
# clean tree (the reference's Jenkinsfile-local build-and-ctest role —
# /root/reference/Jenkinsfile-local, jenkinsut:1-24).
#
# Gates, in order (all on the CPU; the GPU checks are chip_smoke.py and
# bench.py, run on a machine with the card — see README "Tests"):
#   1. native build        (g++ fgio.cpp → libfgio.so, atomic relink)
#   2. lint                (python -m compileall + import every module)
#   3. unit + e2e tests    (pytest on the 8-device virtual CPU mesh)
#   4. multichip dryrun    (full sharded germline step on N virtual devs,
#                           in a child process; this script stays off JAX)
#
# Usage: scripts/ci.sh
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== [1/4] native build =="
bash native/build.sh

echo "== [2/4] lint (compileall + package import) =="
python -m compileall -q falcon_genome_tpu tests bench.py chip_smoke.py __graft_entry__.py
python - <<'EOF'
import importlib, pkgutil
import falcon_genome_tpu
bad = []
for m in pkgutil.walk_packages(falcon_genome_tpu.__path__,
                               "falcon_genome_tpu."):
    try:
        importlib.import_module(m.name)
    except Exception as e:
        bad.append((m.name, e))
assert not bad, bad
print(f"imported {len(list(pkgutil.walk_packages(falcon_genome_tpu.__path__, 'falcon_genome_tpu.')))} modules clean")
EOF

echo "== [3/4] tests (virtual 8-device CPU mesh) =="
JAX_PLATFORMS=cpu python -m pytest tests/ -x -q -m 'not slow'

echo "== [4/4] multichip dryrun (8 virtual devices) =="
XLA_FLAGS="--xla_force_host_platform_device_count=8" JAX_PLATFORMS=cpu \
python - <<'EOF'
import __graft_entry__ as ge
ge.dryrun_multichip(8)
print("dryrun_multichip(8): ok")
EOF

echo "CI: all gates passed"
