"""Ensemble runs: B parameter variants of one scene in a single compiled
program, batched with ``jax.vmap``.

The reference's parameter studies (relaxation/acceleration sensitivity,
README.md:104-123) run the binary once per setting.  On an accelerator the
idiomatic shape is a *batched* simulation: ``vmap`` lifts the fused step over
a leading instance axis, XLA compiles one program whose elementwise work is
B-fold wider (far better utilization than B launch-bound small runs), and
every instance's full av_vels series comes back in one device round trip.

Physics math is the shared ops/stencil_math.py; omega and the acceleration
weights enter as traced per-instance scalars instead of baked constants, so
instance 0 of an ensemble reproduces the single-run path's results exactly
(tested).  The obstacle mask is either shared (parameter sweep) or a
(B, ny, nx) batch vmapped alongside the parameters (geometry sweep — the
reference's obstacle-file studies); the grid shape is common to all
instances either way.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from lbm_tpu.core import lattice
from lbm_tpu.ops import fused_jnp, stencil_math
from lbm_tpu.params import LBMParams
from lbm_tpu.utils.invariants import calc_reynolds

F32 = jnp.float32


@dataclasses.dataclass
class EnsembleResult:
    omegas: np.ndarray  # (B,)
    accels: np.ndarray  # (B,)
    av_vels: np.ndarray  # (num_steps, B)
    f: np.ndarray  # (B, 9, ny, nx) final distributions
    reynolds: np.ndarray  # (B,)


def _step_traced(f, omega, w1, w2, obstacles, accel_row):
    """One timestep with traced omega / accel weights (shared math)."""
    fluid = ~obstacles
    row = fused_jnp.apply_accel_row(f[:, accel_row, :], fluid[accel_row, :], w1, w2)
    f = f.at[:, accel_row, :].set(row)
    streamed = fused_jnp.stream_periodic(f)
    out_planes, tot_u = stencil_math.collide_and_av(
        [streamed[k] for k in range(lattice.NSPEEDS)], obstacles, omega
    )
    return jnp.stack(out_planes), tot_u


def run_ensemble(
    params: LBMParams,
    obstacles: np.ndarray,
    omegas,
    accels=None,
    num_steps: int | None = None,
) -> EnsembleResult:
    """Run B simultaneous variants of one scene, one compiled program.

    Args:
      params: base scene parameters (grid, density, default accel/omega).
      obstacles: (ny, nx) bool mask shared by every instance, OR a
        (B, ny, nx) batch of masks for a GEOMETRY sweep (the reference's
        obstacle-file studies, run simultaneously instead of per binary).
      omegas: (B,) relaxation parameters, one per instance (or a single
        value broadcast over a geometry batch).
      accels: optional (B,) accelerations (default: params.accel for all).
    """
    obstacles = np.asarray(obstacles, dtype=bool)
    omegas = np.atleast_1d(np.asarray(omegas, dtype=np.float32))
    if omegas.ndim != 1 or omegas.size == 0:
        raise ValueError("omegas must be a non-empty 1-D sequence")
    if obstacles.ndim == 3 and omegas.size == 1:
        omegas = np.repeat(omegas, obstacles.shape[0])
    B = omegas.size
    accels = (
        np.full(B, params.accel, dtype=np.float32)
        if accels is None
        else np.asarray(accels, dtype=np.float32)
    )
    if accels.shape != (B,):
        raise ValueError(f"accels must have shape ({B},), got {accels.shape}")
    steps = num_steps if num_steps is not None else params.max_iters

    geom_batch = obstacles.ndim == 3
    if geom_batch and obstacles.shape[0] != B:
        raise ValueError(
            f"obstacle batch of {obstacles.shape[0]} masks does not match "
            f"{B} parameter instances"
        )
    obst = jnp.asarray(obstacles, dtype=bool)
    # Per-instance fluid-cell counts (masks may differ in a geometry sweep).
    fluid_counts = np.asarray(
        (~obstacles).sum(axis=(-2, -1)), dtype=np.float32
    )
    fluid_counts = np.broadcast_to(fluid_counts, (B,)).astype(np.float32)
    accel_row = params.accel_row
    dens = params.density

    # Per-instance accel weights, computed exactly like the single path
    # (lattice.accel_weights: pure f32 arithmetic) but vectorized.
    w1s = jnp.asarray(np.float32(dens) * accels / np.float32(9.0))
    w2s = jnp.asarray(np.float32(dens) * accels / np.float32(36.0))
    om = jnp.asarray(omegas)

    f0 = jnp.asarray(lattice.equilibrium_rest(dens, params.ny, params.nx))
    f0_b = jnp.broadcast_to(f0[None], (B,) + f0.shape)

    batched = jax.vmap(
        lambda f, o, w1, w2, ob: _step_traced(f, o, w1, w2, ob, accel_row),
        in_axes=(0, 0, 0, 0, 0 if geom_batch else None),
    )

    @jax.jit
    def run(f_b):
        def body(f_b, _):
            f_b, tots = batched(f_b, om, w1s, w2s, obst)
            return f_b, tots

        return lax.scan(body, f_b, None, length=steps)

    f_final, tots = run(f0_b)
    av = np.asarray(tots, dtype=np.float32) / fluid_counts[None, :]
    final_av = av[-1] if steps else np.zeros(B, dtype=np.float32)
    reyn = np.asarray(
        [
            calc_reynolds(params.replace(omega=float(o)), float(a))
            for o, a in zip(omegas, final_av)
        ],
        dtype=np.float32,
    )
    return EnsembleResult(
        omegas=omegas,
        accels=accels,
        av_vels=av,
        f=np.asarray(f_final),
        reynolds=reyn,
    )


def parse_range(spec: str, count: int | None = None) -> np.ndarray:
    """Parse ``a:b:n`` (linspace), ``a,b,c`` (list), or ``a`` (scalar)."""
    if ":" in spec:
        parts = spec.split(":")
        if len(parts) != 3:
            raise ValueError(f"range spec must be a:b:n, got {spec!r}")
        a, b, n = float(parts[0]), float(parts[1]), int(parts[2])
        return np.linspace(a, b, n, dtype=np.float32)
    if "," in spec:
        return np.asarray([float(v) for v in spec.split(",")], dtype=np.float32)
    v = float(spec)
    return np.full(count or 1, v, dtype=np.float32)


def render_sweep(res: EnsembleResult, output: str) -> str:
    """Plot the per-instance av_vels families + the final-value curve
    (the ensemble analog of the reference's parameter-study figures)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    B = res.omegas.size
    # Label by whichever parameter varies; a geometry sweep (constant
    # omega AND accel) falls back to instance indices.
    if np.unique(res.omegas).size > 1:
        name, labels = "omega", res.omegas
    elif np.unique(res.accels).size > 1:
        name, labels = "accel", res.accels
    else:
        name, labels = "instance", np.arange(B, dtype=np.float32)
    cmap = plt.get_cmap("viridis")
    for i in range(B):
        ax1.plot(
            res.av_vels[:, i],
            color=cmap(i / max(1, B - 1)),
            label=f"{name}={labels[i]:.4g}",
            linewidth=1.0,
        )
    ax1.set_xlabel("step")
    ax1.set_ylabel("av_velocity")
    ax1.set_title("av_vels per instance")
    if B <= 10:
        ax1.legend(fontsize=7)
    final = (
        res.av_vels[-1]
        if res.av_vels.shape[0]
        else np.full(B, np.nan, dtype=np.float32)
    )
    ax2.plot(labels, final, "o-")
    ax2.set_xlabel(name)
    ax2.set_ylabel("final av_velocity")
    ax2.set_title(f"final av vs {name}")
    fig.tight_layout()
    fig.savefig(output, dpi=120)
    plt.close(fig)
    return output
