#!/usr/bin/env bash
# Multi-process dry run: validates the jax.distributed path locally with
# 2 CPU processes x 4 virtual devices, sync discipline, bitwise vs
# single-device (lbm_tpu/tools/dist_smoke.py) — the analog of the
# reference's 2-node MPI job (MPI/job_submit_d2q9-bgk:4-6).
#
# Usage: scripts/run_pod.sh --dryrun
set -euo pipefail
cd "$(dirname "$0")/.."
source scripts/env.sh

if [ "${1:-}" != "--dryrun" ]; then
    echo "usage: scripts/run_pod.sh --dryrun" >&2
    exit 2
fi
PORT=$(( (RANDOM % 10000) + 20000 ))
python -m lbm_tpu.tools.dist_smoke --process-id 0 --num-processes 2 \
    --coordinator "127.0.0.1:$PORT" &
P0=$!
python -m lbm_tpu.tools.dist_smoke --process-id 1 --num-processes 2 \
    --coordinator "127.0.0.1:$PORT" &
P1=$!
wait $P0 && wait $P1
echo "pod dryrun: both processes passed"
