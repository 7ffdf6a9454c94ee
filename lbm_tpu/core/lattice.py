"""D2Q9 lattice constants and the equilibrium initial condition.

Speed numbering follows the reference (SerialCode/d2q9-bgk.c:9-15):

    6 2 5
     \\|/
    3-0-1
     /|\\
    7 4 8

i.e. 0 = rest, 1 = east, 2 = north, 3 = west, 4 = south, 5 = NE, 6 = NW,
7 = SW, 8 = SE.  Arrays are stored SoA as ``f[9, ny, nx]`` (the reference's
OpenMP variant uses the same structure-of-arrays layout,
OpenMP/d2q9-bgk.c:108-118); row ``jj`` is the y index and column ``ii`` the x
index, matching the reference's row-major `ii + jj*nx` unwrapping.
"""

from __future__ import annotations

import numpy as np

NSPEEDS = 9

# Lattice velocity components per speed (x and y).
CX = (0, 1, 0, -1, 0, 1, -1, -1, 1)
CY = (0, 0, 1, 0, -1, 1, 1, -1, -1)

# Opposite-direction permutation used by bounce-back (SerialCode/d2q9-bgk.c:291-298).
OPP = (0, 3, 4, 1, 2, 7, 8, 5, 6)

# Equilibrium weights (SerialCode/d2q9-bgk.c:309-311).
W0 = 4.0 / 9.0
W1 = 1.0 / 9.0
W2 = 1.0 / 36.0
WEIGHTS = (W0, W1, W1, W1, W1, W2, W2, W2, W2)

# Square of the lattice speed of sound (SerialCode/d2q9-bgk.c:308).
C_SQ = 1.0 / 3.0

# Speeds grouped by sign for the macroscopic velocity moments
# (SerialCode/d2q9-bgk.c:333-347): u_x = (f1+f5+f8 - (f3+f6+f7)) / rho, etc.
UX_POS = (1, 5, 8)
UX_NEG = (3, 6, 7)
UY_POS = (2, 5, 6)
UY_NEG = (4, 7, 8)


def equilibrium_rest(density: float, ny: int, nx: int, dtype=np.float32) -> np.ndarray:
    """Uniform rest-equilibrium distributions, shape ``(9, ny, nx)``.

    Every cell gets centre weight ``density*4/9``, axis weights ``density/9``
    and diagonal weights ``density/36`` (SerialCode/d2q9-bgk.c:546-567).
    """
    w0 = dtype(density) * dtype(4.0) / dtype(9.0)
    w1 = dtype(density) / dtype(9.0)
    w2 = dtype(density) / dtype(36.0)
    f = np.empty((NSPEEDS, ny, nx), dtype=dtype)
    f[0] = w0
    f[1:5] = w1
    f[5:9] = w2
    return f


def equilibrium_rest_device(density: float, ny: int, nx: int):
    """Device-side :func:`equilibrium_rest`: broadcast the 9 per-speed
    weights on device instead of uploading a host-built ``(9, ny, nx)``
    array (a 2.4 GB host allocation and transfer at 8192²).
    Bitwise-identical values.  Single-device init paths only;
    sharded programs keep host arrays so ``device_put`` can scatter them
    without materializing the full grid on one device."""
    import jax.numpy as jnp

    w = equilibrium_rest(density, 1, 1)
    return jnp.broadcast_to(jnp.asarray(w), (NSPEEDS, ny, nx))


def accel_weights(density: float, accel: float, dtype=np.float32):
    """The two per-step injection weights of the driven row.

    ``w1 = density*accel/9`` and ``w2 = density*accel/36``
    (SerialCode/d2q9-bgk.c:219-220).
    """
    w1 = dtype(density) * dtype(accel) / dtype(9.0)
    w2 = dtype(density) * dtype(accel) / dtype(36.0)
    return w1, w2
