#!/usr/bin/env bash
# Runtime environment (the analog of the reference's OpenMP/env.sh, which
# pins thread count and core binding for the CPU build).
#
# Source this before running: `source scripts/env.sh`

# Keep the repo importable without clobbering other site paths.
export PYTHONPATH="$(cd "$(dirname "${BASH_SOURCE[0]}")/.." && pwd):${PYTHONPATH:-}"

# JAX reserves most of the GPU's memory at start-up (its default); one
# process per card.  Set XLA_PYTHON_CLIENT_MEM_FRACTION to share a card.
export XLA_PYTHON_CLIENT_PREALLOCATE=${XLA_PYTHON_CLIENT_PREALLOCATE:-true}
