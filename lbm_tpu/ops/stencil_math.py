"""Shared per-cell D2Q9-BGK math.

Used by the XLA step (ops/fused_jnp.py), the block kernel
(ops/fused_pallas.py) and the ensemble sweep, so every backend evaluates the
same expression tree per cell.

Two deviations from the literal reference expression order
(SerialCode/d2q9-bgk.c:306-458), both mathematically identical in exact
arithmetic and verified to stay far inside the 1% output tolerance over full
40000-step runs:

- **paired equilibria**: opposite directions share their quadratic term,
  ``d_equ(+-u) = A +- Bu`` with ``A = w*rho*(1 + 4.5u^2 - 1.5|u|^2)`` and
  ``Bu = w*rho*3u`` — half the arithmetic of evaluating the 2nd-order
  equilibrium separately per direction;
- **moment-reused av_velocity**: BGK conserves per-cell density and momentum
  (the equilibrium has the same first moments), so |u| for the per-step
  reduction is computed from the pre-collision moments instead of re-deriving
  them from post-collision distributions as the reference does
  (SerialCode/d2q9-bgk.c:409-458).
"""

from __future__ import annotations

import jax.numpy as jnp

from lbm_tpu.core import lattice

F32 = jnp.float32
NS = lattice.NSPEEDS


def moments(t):
    """Per-cell density and velocity from 9 distribution planes
    (SerialCode/d2q9-bgk.c:324-347)."""
    rho = ((((((((t[0] + t[1]) + t[2]) + t[3]) + t[4]) + t[5]) + t[6]) + t[7]) + t[8])
    u_x = ((t[1] + t[5] + t[8]) - (t[3] + t[6] + t[7])) / rho
    u_y = ((t[2] + t[5] + t[6]) - (t[4] + t[7] + t[8])) / rho
    return rho, u_x, u_y


def collide(t, obst, omega, rho, u_x, u_y, u_sq):
    """Bounce-back + paired-equilibrium BGK relaxation.

    ``t`` are the 9 streamed planes; obstacle cells receive mirrored streamed
    values (rebound, SerialCode/d2q9-bgk.c:279-304), fluid cells relax toward
    equilibrium (collision, SerialCode/d2q9-bgk.c:306-407).
    """
    one = F32(1.0)
    usq_term = u_sq * F32(1.5)
    w0rho = (F32(4.0 / 9.0) * rho)
    w1rho = (F32(1.0 / 9.0) * rho)
    w2rho = (F32(1.0 / 36.0) * rho)
    base = one - usq_term

    d_equ = [None] * NS
    d_equ[0] = w0rho * base
    for kp, km, u, wrho in (
        (1, 3, u_x, w1rho),
        (2, 4, u_y, w1rho),
        (5, 7, u_x + u_y, w2rho),
        (6, 8, u_y - u_x, w2rho),
    ):
        a = wrho * (base + F32(4.5) * (u * u))
        b = wrho * (F32(3.0) * u)
        d_equ[kp] = a + b
        d_equ[km] = a - b

    out = []
    for k in range(NS):
        relaxed = t[k] + omega * (d_equ[k] - t[k])
        if k == 0:
            out.append(jnp.where(obst, t[0], relaxed))
        else:
            out.append(jnp.where(obst, t[lattice.OPP[k]], relaxed))
    return out


def speed_sum(u_sq, fluid):
    """Sum over fluid cells of |u| = sqrt(u_sq)."""
    return jnp.sum(jnp.where(fluid, jnp.sqrt(u_sq), F32(0.0)), dtype=F32)


def collide_and_av(streamed, obst, omega):
    """Full post-stream cell update: returns (9 planes, tot_u partial)."""
    rho, u_x, u_y = moments(streamed)
    u_sq = u_x * u_x + u_y * u_y
    out = collide(streamed, obst, omega, rho, u_x, u_y, u_sq)
    fluid = jnp.logical_not(obst)
    return out, speed_sum(u_sq, fluid)
