"""int16 fixed-point deviation storage for the distribution state.

The step is bound by memory traffic (it moves at least 72 B per cell in
f32 against ~130 flops), so halving the bytes per lattice value doubles the
ceiling.  bf16 does not work here:

- raw bf16 state diverges (measured 50% av_vels error at 128^2): f values
  sit near w_k*rho0, so bf16's 8-bit mantissa rounds the physically
  meaningful *deviation* to ~2 bits;
- bf16 deviations (f - w_k*rho0) still drift to 3.7% over 40000 steps.

f16 deviations were measured at 0.11% vs the golden (an open alternative,
not implemented).  int16 fixed-point deviations: store
``q = round((f - w_k*rho0) * s_k)`` with per-plane scale
``s_k = 32767 / (RANGE_C * w_k * rho0)``.  The representable deviation range
is RANGE_C * 100% of the rest weight — measured flow peaks at 17.8% over a
full 128^2 run, so RANGE_C = 2 keeps 11x headroom (stores saturate rather
than wrap, degrading gracefully) — and the quantization step is uniform at
``RANGE_C * w_k * rho0 / 32767`` ~ 6e-5 relative to f: measured 0.13-0.32%
max av_vels deviation vs the reference goldens over 40000 steps, well inside
the 1% contract (check/check.py:19-24).

Exactness property: obstacle (bounce-back) cells only mirror stored values;
dequantize -> mirror -> requantize reproduces the identical int16 (the f32
round-trip error is ~1e-3 of one quantization step), so walls do not drift.

The reference has no reduced-precision mode — all variants are float
(SerialCode/d2q9-bgk.c:78-81); this is a capability addition.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from lbm_tpu.core import lattice

# Representable deviation range, in units of the rest distribution w_k*rho0.
RANGE_C = 2.0
_QMAX = 32767.0

I16 = jnp.int16
F32 = jnp.float32


def plane_scales(density: float) -> np.ndarray:
    """Per-plane quantization scale s_k (float32, shape (9,)):
    q = round((f_k - w_k*density) * s_k)."""
    w = np.asarray(lattice.WEIGHTS, dtype=np.float64) * float(density)
    return (_QMAX / (RANGE_C * w)).astype(np.float32)


def plane_rest(density: float) -> np.ndarray:
    """Per-plane rest value w_k*density (float32, shape (9,))."""
    return (np.asarray(lattice.WEIGHTS, dtype=np.float64) * float(density)).astype(
        np.float32
    )


def round_half_even(x):
    """``jnp.round`` (nearest integer, ties to even) from floor, compares
    and selects — primitives every backend lowers, the Triton route
    included, which has no round primitive.  Exact: ``a - floor(a)`` is
    exact for ``a >= 0``, and rounding is odd-symmetric, so ``|x|`` is
    rounded and the sign restored.  (``(x + 1.5*2**23) - 1.5*2**23`` would
    not do: XLA folds it to ``x`` under jit.)
    """
    a = jnp.abs(x)
    r = jnp.floor(a)
    d = a - r
    odd = (r - F32(2.0) * jnp.floor(r * F32(0.5))) == F32(1.0)
    up = (d > F32(0.5)) | ((d == F32(0.5)) & odd)
    r = jnp.where(up, r + F32(1.0), r)
    return jnp.where(x < F32(0.0), -r, r)


def quantize_plane(f_k, k: int, density: float):
    """f32 plane -> int16 quantized deviations (jnp; usable in kernels)."""
    s = float(plane_scales(density)[k])
    rest = float(plane_rest(density)[k])
    q = round_half_even((f_k - F32(rest)) * F32(s))
    return jnp.clip(q, -_QMAX, _QMAX).astype(I16)


def dequantize_plane(q_k, k: int, density: float):
    """int16 quantized deviations -> f32 plane (jnp; usable in kernels)."""
    s = float(plane_scales(density)[k])
    rest = float(plane_rest(density)[k])
    return q_k.astype(F32) * F32(1.0 / s) + F32(rest)


def plane_codec(storage: str, density: float):
    """Per-plane (dequantize, quantize) pair for a kernel's storage mode.

    ``f32`` returns identity codecs; ``i16`` wraps loads/stores in the
    fixed-point deviation transform."""
    if storage == "i16":
        return (
            lambda x, k: dequantize_plane(x, k, density),
            lambda x, k: quantize_plane(x, k, density),
        )
    if storage != "f32":
        raise ValueError(f"unknown storage {storage!r}")
    ident = lambda x, k: x
    return ident, ident


def quantize(f, density: float):
    """(9, ...) f32 distributions -> int16 state (leading axis = planes)."""
    return jnp.stack(
        [quantize_plane(f[k], k, density) for k in range(lattice.NSPEEDS)]
    )


def dequantize(q, density: float):
    """(9, ...) int16 state -> f32 distributions."""
    return jnp.stack(
        [dequantize_plane(q[k], k, density) for k in range(lattice.NSPEEDS)]
    )
