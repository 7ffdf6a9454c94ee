"""Fused collide-stream block kernel, Pallas through Triton.

One kernel performs the driven-row injection, 9-direction pull streaming,
bounce-back, BGK collision and the per-step |u| partial in a single pass
over the distribution planes — the hand-written counterpart of the
reference's fused ``fusion_more`` kernels (OpenMP/d2q9-bgk.c:260-498,
MPI/d2q9-bgk.c:333-535) and of the XLA-fused step in ops/fused_jnp.py,
whose arithmetic (ops/stencil_math.py) it reuses.

Design (one program per output tile):

- the grid is cut into 2-D power-of-two tiles ``(by, bx)``; tail tiles
  clamp their indices, so an out-of-range lane recomputes (and rewrites)
  its edge cell and is left out of the |u| partial;
- each program loads its 9 neighbour-shifted tiles straight from global
  memory (the overlap between neighbouring tiles is served by L1/L2), with
  the periodic x wrap — and the y wrap of the full-grid form — folded into
  the load indices.  Nothing is carried between programs;
- the driven-row injection is applied to loaded values whose source row is
  the driven row, from three row vectors per column shift (planes 3, 6, 7
  and the obstacle flag of that row);
- the collision runs in registers; each program writes its 9 output tiles
  and ONE |u| partial, which XLA sums in a fixed order (no atomics, so
  results are deterministic).

One kernel serves both forms — the periodic full grid and the ghosted row
slab of the sharded modes (whose global row offset arrives at run time) —
and both f32 and int16 state (ops/quant.py codec applied per plane on load
and store).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from lbm_tpu.core import lattice
from lbm_tpu.ops import quant, stencil_math
from lbm_tpu.params import LBMParams

F32 = jnp.float32
NS = lattice.NSPEEDS

# (rows, columns, warps) of one program's tile: the best or within 1% of
# the best of ten shapes at 1024^2 and 8192^2, f32 and i16, on an H100
# (PERF.md).
DEFAULT_BLOCK = (2, 256, 4)

# Driven-row injection per speed: (weight index, sign); weight 1 = w1,
# 2 = w2 (SerialCode/d2q9-bgk.c:216-246).  Speeds 0, 2, 4 are untouched.
_ACCEL = {1: (1, 1.0), 3: (1, -1.0), 5: (2, 1.0), 6: (2, -1.0),
          7: (2, -1.0), 8: (2, 1.0)}


def _wrap(idx, n: int):
    """Indices in [-1, n] folded periodically into [0, n)."""
    idx = jnp.where(idx < 0, idx + n, idx)
    return jnp.where(idx >= n, idx - n, idx)


def _kernel(
    g0_ref, f_ref, obst_ref, out_ref, part_ref, *,
    n_out: int, n_src: int, nx: int, ny_global: int, wrap_y: bool,
    accel_row: int, w1, w2, omega, density: float, storage: str,
    by: int, bx: int, gx: int, tot_rows: tuple[int, int],
):
    i = pl.program_id(0)
    j = pl.program_id(1)
    rows = i * by + lax.iota(jnp.int32, by)
    cols = j * bx + lax.iota(jnp.int32, bx)
    # Cells that enter the |u| partial: in the grid, and in tot_rows.
    counted = (rows >= tot_rows[0]) & (rows < tot_rows[1])
    valid = counted[:, None] & (cols < nx)[None, :]
    rows = jnp.minimum(rows, n_out - 1)
    cols = jnp.minimum(cols, nx - 1)
    deq, q = quant.plane_codec(storage, density)
    # Source row offset: the slab form's output row r reads slab row r+1.
    shift = 0 if wrap_y else 1
    # Global row of source row 0 (0 for the full grid; row_offset-1 for a
    # ghosted slab), and the driven row's position among the source rows.
    g0 = g0_ref[0]
    acc_src = lax.rem(accel_row - g0 + 2 * ny_global, ny_global)
    acc_src = jnp.minimum(acc_src, n_src - 1)

    src_cols = {dx: _wrap(cols - dx, nx) for dx in (-1, 0, 1)}
    # Injection guard per column shift: fluid source cell whose three
    # decremented west-side speeds stay positive.
    zero = F32(0.0)
    ok = {}
    for dx, sc in src_cols.items():
        fluid = obst_ref[acc_src, sc] == 0
        ok[dx] = (
            fluid
            & (deq(f_ref[3, acc_src, sc], 3) - w1 > zero)
            & (deq(f_ref[6, acc_src, sc], 6) - w2 > zero)
            & (deq(f_ref[7, acc_src, sc], 7) - w2 > zero)
        )

    planes = []
    for k in range(NS):
        sr = rows + shift - lattice.CY[k]
        if wrap_y:
            sr = _wrap(sr, n_src)
        sc = src_cols[lattice.CX[k]]
        v = deq(f_ref[k, sr[:, None], sc[None, :]], k)
        if k in _ACCEL:
            w_idx, sign = _ACCEL[k]
            delta = F32(sign) * (w1 if w_idx == 1 else w2)
            g = lax.rem(g0 + sr + ny_global, ny_global)
            hit = (g == accel_row)[:, None] & ok[lattice.CX[k]][None, :]
            v = v + jnp.where(hit, delta, zero)
        planes.append(v)

    obst = obst_ref[rows[:, None] + shift, cols[None, :]] != 0
    rho, u_x, u_y = stencil_math.moments(planes)
    u_sq = u_x * u_x + u_y * u_y
    out = stencil_math.collide(planes, obst, omega, rho, u_x, u_y, u_sq)
    # Unmasked stores: a clamped tail lane recomputes its edge cell from
    # the same sources, so duplicate writes carry identical values.
    for k in range(NS):
        out_ref[k, rows[:, None], cols[None, :]] = q(out[k], k).astype(
            out_ref.dtype
        )
    speed = jnp.where(valid & ~obst, jnp.sqrt(u_sq), zero)
    part = jnp.sum(speed, dtype=F32)
    plgpu.store(part_ref.at[pl.ds(i * gx + j, 1)], jnp.reshape(part, (1,)))


def _state_dtype(storage: str):
    if storage == "f32":
        return F32
    if storage == "i16":
        return quant.I16
    raise ValueError(f"unknown storage {storage!r}; use 'f32' or 'i16'")


def _build_call(
    params: LBMParams, n_out: int, n_src: int, nx: int, ny_global: int,
    wrap_y: bool, storage: str, block, interpret: bool,
    tot_rows: tuple[int, int] | None = None,
):
    platform = jax.default_backend()
    if not interpret and platform != "gpu":
        raise ValueError(
            f"the block kernel (--backend pallas) compiles for a GPU through "
            f"Triton; this process runs on {platform!r}; use --backend jnp"
        )
    by, bx, warps = block
    gy, gx = pl.cdiv(n_out, by), pl.cdiv(nx, bx)
    w1, w2 = lattice.accel_weights(params.density, params.accel)
    kernel = functools.partial(
        _kernel,
        n_out=n_out, n_src=n_src, nx=nx, ny_global=ny_global,
        wrap_y=wrap_y, accel_row=params.accel_row, w1=w1, w2=w2,
        omega=np.float32(params.omega), density=float(params.density),
        storage=storage, by=by, bx=bx, gx=gx,
        tot_rows=tot_rows or (0, n_out),
    )
    return pl.pallas_call(
        kernel,
        out_shape=(
            jax.ShapeDtypeStruct((NS, n_out, nx), _state_dtype(storage)),
            jax.ShapeDtypeStruct((gy * gx,), F32),
        ),
        grid=(gy, gx),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=warps, num_stages=1),
        interpret=interpret,
        name="lbm_block_step",
    )


def obstacle_codes(obstacles) -> np.ndarray:
    """The kernel's obstacle layout: int8, nonzero = blocked."""
    return np.asarray(obstacles).astype(np.int8)


def make_step(
    params: LBMParams,
    obstacles: np.ndarray,
    storage: str = "f32",
    block=DEFAULT_BLOCK,
    interpret: bool = False,
):
    """Full-grid periodic step: ``f -> (f_new, tot_u)`` over a (9, ny, nx)
    state in ``storage`` representation."""
    ny, nx = np.asarray(obstacles).shape
    call = _build_call(params, ny, ny, nx, ny, True, storage, block, interpret)
    obst = jnp.asarray(obstacle_codes(obstacles))
    g0 = jnp.zeros((1,), jnp.int32)

    def step(f):
        out, parts = call(g0, f, obst)
        return out, jnp.sum(parts)

    return step


def make_slab_step(
    params: LBMParams,
    n: int,
    nx: int,
    ny_global: int,
    storage: str = "f32",
    block=DEFAULT_BLOCK,
    interpret: bool = False,
    tot_rows: tuple[int, int] | None = None,
):
    """Ghosted-slab step: ``(slab (9, n+2, nx), obstacle codes (n+2, nx),
    row_offset) -> ((9, n, nx), tot_u)``; ``row_offset`` is the global row
    of slab row 1 and may be traced (the shard's axis index).  Slab rows
    wrap modulo ``ny_global`` when locating the driven row; ``tot_rows``
    ``(lo, hi)`` restricts the |u| sum to those output rows (default all).

    A slab taller than the grid holds some global rows twice (deep ca halos
    on few shards); every copy carries the same values, so the injection
    guard may read any copy of the driven row.
    """
    if n < 1:
        raise ValueError(f"a slab needs at least one output row, got {n}")
    call = _build_call(
        params, n, n + 2, nx, ny_global, False, storage, block, interpret,
        tot_rows,
    )

    def step_slab(slab, obst_slab, row_offset):
        g0 = jnp.reshape(row_offset - 1, (1,)).astype(jnp.int32)
        out, parts = call(g0, slab, obst_slab)
        return out, jnp.sum(parts)

    return step_slab
