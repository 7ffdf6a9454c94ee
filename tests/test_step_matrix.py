"""Every per-step implementation against the NumPy oracle (core/oracle.py).

The matrix: step implementation (the XLA step; the Triton block kernel in
the Pallas interpreter) x grid shape (square, non-power-of-two widths and
heights, tiles that do not divide the grid) x form (periodic full grid;
ghosted slab at row offsets that put the driven row in the body, in a ghost
row, in different tiles, or nowhere) x storage (f32; i16, against the
oracle within the quantization envelope) x random obstacle seeds.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from lbm_tpu.core import lattice, oracle
from lbm_tpu.ops import fused_jnp, fused_pallas, quant
from lbm_tpu.params import LBMParams

IMPLS = ["jnp", "pallas"]
# f32 fields vs the oracle after a few steps: FMA-free float32 arithmetic
# in another expression order (the repo's oracle tolerance); i16 adds up
# to one quantization step (<= 2.7e-6) per step.
FIELD_ATOL = {"f32": 3e-7, "i16": 2e-5}
STEPS = 5


def _scene(ny, nx, seed, accel=0.01):
    params = LBMParams(
        nx=nx, ny=ny, max_iters=STEPS, reynolds_dim=10,
        density=0.1, accel=accel, omega=1.85,
    )
    rng = np.random.default_rng(seed)
    mask = rng.random((ny, nx)) < 0.1
    mask[0, :] = mask[-1, :] = True
    mask[ny // 2, nx // 2] = False
    return params, mask


def _perturbed_state(params, seed):
    rng = np.random.default_rng(seed)
    f = lattice.equilibrium_rest(params.density, params.ny, params.nx)
    return (f * (1 + 0.05 * rng.random(f.shape))).astype(np.float32)


def _full_step(impl, params, mask, storage):
    """state -> (state, tot_u) over the full grid, in ``storage``."""
    if impl == "pallas":
        return fused_pallas.make_step(
            params, mask, storage=storage, block=(8, 32, 4), interpret=True
        )
    obst = jnp.asarray(mask)
    dens = params.density

    def step(s):
        f = quant.dequantize(s, dens) if storage == "i16" else s
        f, tot = fused_jnp.fused_step_single(f, obst, params)
        return (quant.quantize(f, dens) if storage == "i16" else f), tot

    return step


def _run_full(impl, params, mask, storage, f0):
    dens = params.density
    s = jnp.asarray(f0)
    if storage == "i16":
        s = quant.quantize(s, dens)
    step = _full_step(impl, params, mask, storage)
    tots = []
    for _ in range(STEPS):
        s, tot = step(s)
        tots.append(float(tot))
    f = quant.dequantize(s, dens) if storage == "i16" else s
    return np.asarray(f), np.asarray(tots, np.float32)


@pytest.mark.parametrize("storage", ["f32", "i16"])
@pytest.mark.parametrize(
    "ny,nx", [(128, 128), (16, 16), (24, 40), (37, 130), (64, 96)]
)
@pytest.mark.parametrize("impl", IMPLS)
def test_full_grid_matches_oracle(impl, ny, nx, storage):
    params, mask = _scene(ny, nx, seed=ny * 1000 + nx)
    f0 = lattice.equilibrium_rest(params.density, ny, nx)
    f, tots = _run_full(impl, params, mask, storage, f0)
    f_o, av_o = oracle.run(params, mask, f=f0, num_steps=STEPS)
    np.testing.assert_allclose(f, f_o, atol=FIELD_ATOL[storage])
    fluid = np.float32(mask.size - np.count_nonzero(mask))
    rtol = 2e-4 if storage == "f32" else 2e-2
    np.testing.assert_allclose(tots / fluid, av_o, rtol=rtol)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("impl", IMPLS)
def test_random_obstacles_match_oracle(impl, seed):
    """Random obstacle density and a perturbed (non-rest) start, so the
    driven row's positivity guard and bounce-back both see varied input."""
    rng = np.random.default_rng(500 + seed)
    ny, nx = int(rng.choice([12, 20, 33])), int(rng.choice([24, 48, 70]))
    params, _ = _scene(ny, nx, seed)
    mask = rng.random((ny, nx)) < rng.uniform(0.05, 0.4)
    mask[ny // 2, nx // 2] = False
    f0 = _perturbed_state(params, seed)
    f, _ = _run_full(impl, params, mask, "f32", f0)
    f_o, _ = oracle.run(params, mask, f=f0, num_steps=STEPS)
    np.testing.assert_allclose(f, f_o, atol=FIELD_ATOL["f32"])


# Row offsets of a 16-row slab of a 40-row grid (driven row 38): in the
# body's last tile, in the body's first tile, in the upper ghost, in the
# lower ghost (wrapped), and nowhere.
SLAB_OFFSETS = [24, 37, 22, 0, 8]


@pytest.mark.parametrize("storage", ["f32", "i16"])
@pytest.mark.parametrize("offset", SLAB_OFFSETS)
@pytest.mark.parametrize("impl", IMPLS)
def test_slab_form_matches_oracle(impl, offset, storage):
    ny, nx, n = 40, 48, 16
    params, mask = _scene(ny, nx, seed=offset)
    f_full = _perturbed_state(params, offset)
    rows = np.arange(offset - 1, offset + n + 1) % ny
    slab = f_full[:, rows, :]
    dens = params.density
    if impl == "pallas":
        step = fused_pallas.make_slab_step(
            params, n, nx, ny, storage=storage, block=(8, 32, 4),
            interpret=True,
        )
        obst = jnp.asarray(fused_pallas.obstacle_codes(mask[rows]))
        s = jnp.asarray(slab)
        if storage == "i16":
            s = quant.quantize(s, dens)
        out, tot = step(s, obst, offset)
        out = quant.dequantize(out, dens) if storage == "i16" else out
    else:
        s = jnp.asarray(slab)
        if storage == "i16":
            s = quant.dequantize(quant.quantize(s, dens), dens)
        out, tot = fused_jnp.fused_step_slab(
            s, jnp.asarray(mask[rows]), params, offset, ny_global=ny
        )
        if storage == "i16":
            out = quant.dequantize(quant.quantize(out, dens), dens)
    if storage == "i16":
        # The oracle steps the dequantized input, so both start alike.
        f_full = np.array(
            quant.dequantize(quant.quantize(jnp.asarray(f_full), dens), dens)
        )
    f_o = oracle.timestep(f_full, mask, params)
    own = np.arange(offset, offset + n) % ny
    np.testing.assert_allclose(
        np.asarray(out), f_o[:, own, :], atol=FIELD_ATOL[storage]
    )
    speed = np.sqrt(sum(c * c for c in oracle.velocity(f_o)))
    tot_o = np.sum(np.where(mask[own], 0.0, speed[own]), dtype=np.float64)
    np.testing.assert_allclose(float(tot), tot_o, rtol=1e-4)


@pytest.mark.parametrize("tot_rows", [(0, 16), (3, 13), (7, 8)])
def test_block_kernel_row_restricted_tot(tot_rows):
    """The slab form's |u| sum over a row range (what the ca levels count)
    equals the XLA slab step's over the same rows."""
    ny, nx, n = 40, 48, 16
    params, mask = _scene(ny, nx, seed=9)
    f_full = _perturbed_state(params, 9)
    rows = np.arange(9, 9 + n + 2) % ny
    step = fused_pallas.make_slab_step(
        params, n, nx, ny, block=(8, 32, 4), interpret=True,
        tot_rows=tot_rows,
    )
    _, tot = step(
        jnp.asarray(f_full[:, rows, :]),
        jnp.asarray(fused_pallas.obstacle_codes(mask[rows])), 10,
    )
    _, tot_ref = fused_jnp.fused_step_slab(
        jnp.asarray(f_full[:, rows, :]), jnp.asarray(mask[rows]), params, 10,
        ny_global=ny, tot_rows=tot_rows,
    )
    np.testing.assert_allclose(float(tot), float(tot_ref), rtol=1e-5)
