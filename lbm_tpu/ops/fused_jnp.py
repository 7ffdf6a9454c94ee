"""Fused collide-stream timestep in pure jnp.

This is the XLA-fusion reference implementation of the framework's core op:
one sweep that performs accelerate + pull-streaming + bounce-back + BGK
collision + the per-step velocity reduction, i.e. the same fusion the
reference's parallel variants use (``fusion_more``, OpenMP/d2q9-bgk.c:260-498,
MPI/d2q9-bgk.c:333-535), producing identical math to the serial 4-pass
algorithm (SerialCode/d2q9-bgk.c:207-458).

Two forms are provided:

- :func:`fused_step_single` — full-grid periodic step (single device), with
  streaming expressed as ``jnp.roll`` so XLA fuses the 9 shifted reads into
  the elementwise collision.
- :func:`fused_step_slab` — step over a row slab with one ghost row on each
  side, the building block for row-sharded multi-chip execution (ghost rows
  play the role of the reference's MPI halo rows, MPI/d2q9-bgk.c:205-248)
  and the per-level step of the communication-avoiding (ca) mode.

All arithmetic is float32; the cell update uses the shared
math of ops/stencil_math.py (paired equilibria, moment-reused av_velocity),
validated to track the golden data far inside the 1% tolerance over full
runs.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from lbm_tpu.core import lattice
from lbm_tpu.params import LBMParams

F32 = jnp.float32


class StepOutput(NamedTuple):
    f: jax.Array  # (9, ny, nx) post-collision distributions
    tot_u: jax.Array  # scalar: sum over fluid cells of |u| (pre-division)


def _f32(x: float) -> np.float32:
    return np.float32(x)


def apply_accel_row(row: jax.Array, fluid_row: jax.Array, w1, w2) -> jax.Array:
    """Driven-row injection on a (9, nx) row (SerialCode/d2q9-bgk.c:216-246).

    Guard: fluid cell AND all three decremented west-side speeds stay
    strictly positive.
    """
    zero = _f32(0.0)
    ok = (
        fluid_row
        & (row[3] - w1 > zero)
        & (row[6] - w2 > zero)
        & (row[7] - w2 > zero)
    )
    deltas = jnp.stack(
        [
            jnp.zeros_like(row[0]),
            jnp.where(ok, w1, zero),
            jnp.zeros_like(row[0]),
            jnp.where(ok, -w1, zero),
            jnp.zeros_like(row[0]),
            jnp.where(ok, w2, zero),
            jnp.where(ok, -w2, zero),
            jnp.where(ok, -w2, zero),
            jnp.where(ok, w2, zero),
        ]
    )
    return row + deltas


def stream_periodic(f: jax.Array) -> jax.Array:
    """Full-grid pull streaming with periodic wrap on both axes
    (SerialCode/d2q9-bgk.c:248-277): ``tmp[k][j,i] = f[k][j-cy, i-cx]``."""
    return jnp.stack(
        [
            jnp.roll(f[k], (lattice.CY[k], lattice.CX[k]), axis=(0, 1))
            for k in range(lattice.NSPEEDS)
        ]
    )


def stream_slab(slab: jax.Array) -> jax.Array:
    """Pull streaming over a ghosted row slab.

    ``slab`` is (9, n+2, nx): row 0 and row n+1 are ghost rows (the halo rows
    of the reference's row decomposition, MPI/d2q9-bgk.c:674-695).  x wraps
    periodically; y reads come from the slab.  Returns (9, n, nx).
    """
    n = slab.shape[1] - 2
    planes = []
    for k in range(lattice.NSPEEDS):
        rows = slab[k, 1 - lattice.CY[k] : 1 - lattice.CY[k] + n, :]
        planes.append(jnp.roll(rows, lattice.CX[k], axis=1))
    return jnp.stack(planes)


def fused_step_single(
    f: jax.Array, obstacles: jax.Array, params: LBMParams
) -> StepOutput:
    """One full timestep on a single device (periodic full grid).

    Uses the shared cell math (ops/stencil_math.py), as does the block
    kernel in ops/fused_pallas.py.
    """
    from lbm_tpu.ops import stencil_math

    w1, w2 = lattice.accel_weights(params.density, params.accel)
    jj = params.accel_row
    fluid = ~obstacles
    row = apply_accel_row(f[:, jj, :], fluid[jj, :], w1, w2)
    f = f.at[:, jj, :].set(row)
    streamed = stream_periodic(f)
    out_planes, tot_u = stencil_math.collide_and_av(
        [streamed[k] for k in range(lattice.NSPEEDS)], obstacles, _f32(params.omega)
    )
    return StepOutput(jnp.stack(out_planes), tot_u)


def fused_step_slab(
    slab: jax.Array,
    obstacles_slab: jax.Array,
    params: LBMParams,
    row_offset,
    ny_global: int | None = None,
    tot_rows: tuple[int, int] | None = None,
) -> StepOutput:
    """One timestep over a ghosted row slab (the sharded building block).

    Args:
      slab: (9, n+2, nx) distributions including ghost rows, *pre-accel*.
      obstacles_slab: (n+2, nx) bool obstacle mask including ghost rows.
      params: simulation parameters (static).
      row_offset: global row index of slab row 1 (the first owned row);
        may be traced (a shard's axis index times its row count).
      ny_global: rows of the global (periodic) grid.  When given, slab row
        indices wrap modulo it, so a slab that reaches past either edge of
        the grid (the deep halos of the ca mode) still finds the driven row.
      tot_rows: ``(lo, hi)`` output rows whose |u| enters ``tot_u``
        (default: all n) — the ca mode counts only the rows a shard owns.

    The driven-row injection is applied to every slab row (ghosts included)
    whose *global* index is ``ny-2``, which reproduces exactly what the
    owning shard computes for that row — the even-sharding replacement for
    the reference's "last rank owns the accelerated row" layout
    (MPI/d2q9-bgk.c:674-695, 342-366).
    """
    from lbm_tpu.ops import stencil_math

    w1, w2 = lattice.accel_weights(params.density, params.accel)
    n = slab.shape[1] - 2
    global_rows = row_offset - 1 + jnp.arange(n + 2)
    if ny_global is not None:
        global_rows = global_rows % ny_global
    accel_rows = global_rows == params.accel_row
    fluid_slab = ~obstacles_slab
    # apply_accel_row broadcasts over the row dimension; restricting the
    # fluid mask to driven rows confines the injection to them.
    slab = apply_accel_row(slab, fluid_slab & accel_rows[:, None], w1, w2)
    streamed = stream_slab(slab)
    obstacles_own = obstacles_slab[1 : 1 + n]
    rho, u_x, u_y = stencil_math.moments(
        [streamed[k] for k in range(lattice.NSPEEDS)]
    )
    u_sq = u_x * u_x + u_y * u_y
    out_planes = stencil_math.collide(
        [streamed[k] for k in range(lattice.NSPEEDS)],
        obstacles_own, _f32(params.omega), rho, u_x, u_y, u_sq,
    )
    lo, hi = tot_rows if tot_rows is not None else (0, n)
    tot_u = stencil_math.speed_sum(u_sq[lo:hi], ~obstacles_own[lo:hi])
    return StepOutput(jnp.stack(out_planes), tot_u)


def make_single_step(params: LBMParams, obstacles: np.ndarray):
    """Build a jitted single-device step: ``f -> (f_new, tot_u)``."""
    obst = jnp.asarray(obstacles, dtype=bool)

    @jax.jit
    def step(f):
        return fused_step_single(f, obst, params)

    return step
