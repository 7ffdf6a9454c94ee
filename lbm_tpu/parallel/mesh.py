"""Device mesh construction for row decomposition.

The reference decomposes the grid into contiguous row bands across MPI ranks
on a periodic ring (up = (r-1+P)%P, down = (r+1)%P, MPI/d2q9-bgk.c:205-211,
674-695).  The equivalent here is a 1-D ``jax.sharding.Mesh`` whose single
axis ``'rows'`` shards the y-dimension of the distribution arrays; halo
exchange is a ``lax.ppermute`` ring shift, which XLA hands to NCCL (on a
host whose GPUs all reach each other over NVLink, the ring needs no device
order).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ROWS = "rows"


def make_row_mesh(num_devices: int | None = None, devices=None) -> Mesh:
    """Build a 1-D mesh over ``num_devices`` devices (default: all)."""
    if devices is None:
        devices = jax.devices()
    if num_devices is not None:
        if num_devices > len(devices):
            raise ValueError(
                f"requested {num_devices} devices but only {len(devices)} available"
            )
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (ROWS,))


def row_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding of the (9, ny, nx) distribution array: rows over the mesh."""
    return NamedSharding(mesh, P(None, ROWS, None))


def mask_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding of the (ny, nx) obstacle mask."""
    return NamedSharding(mesh, P(ROWS, None))


def ring_perms(num_shards: int):
    """Forward (to r+1) and backward (to r-1) ring permutations — the analog
    of the reference's periodic up/down neighbors (MPI/d2q9-bgk.c:210-211)."""
    fwd = [(i, (i + 1) % num_shards) for i in range(num_shards)]
    bwd = [(i, (i - 1) % num_shards) for i in range(num_shards)]
    return fwd, bwd
