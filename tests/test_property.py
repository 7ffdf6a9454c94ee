"""Randomized cross-implementation property tests.

The reference validates only its four fixed scenes; these tests fuzz random
obstacle geometries and parameters against the NumPy oracle to pin the fused
backends' semantics on inputs nobody hand-checked.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from lbm_tpu.core import lattice, oracle
from lbm_tpu.ops import fused_jnp
from lbm_tpu.params import LBMParams
from lbm_tpu.utils import invariants


def _random_scene(seed: int):
    rng = np.random.default_rng(seed)
    ny = int(rng.choice([8, 16, 24]))
    nx = int(rng.choice([8, 16, 32]))
    params = LBMParams(
        nx=nx,
        ny=ny,
        max_iters=12,
        reynolds_dim=10,
        density=float(rng.uniform(0.05, 0.3)),
        accel=float(rng.uniform(0.001, 0.01)),
        omega=float(rng.uniform(0.8, 1.9)),
    )
    mask = rng.random((ny, nx)) < rng.uniform(0.0, 0.25)
    # Keep at least one fluid cell.
    mask[ny // 2, nx // 2] = False
    return params, mask


@pytest.mark.parametrize("seed", range(8))
def test_fused_matches_oracle_on_random_scenes(seed):
    params, mask = _random_scene(seed)
    f_o, av_o = oracle.run(params, mask, num_steps=12)

    step = fused_jnp.make_single_step(params, mask)
    f = jnp.asarray(lattice.equilibrium_rest(params.density, params.ny, params.nx))
    tots = []
    for _ in range(12):
        f, tu = step(f)
        tots.append(float(tu))
    fluid = mask.size - np.count_nonzero(mask)
    av = np.asarray(tots, np.float32) / np.float32(fluid)

    np.testing.assert_allclose(np.asarray(f), f_o, atol=3e-7)
    np.testing.assert_allclose(av, av_o, rtol=2e-4)
    # Mass conservation holds on arbitrary geometry.
    expected = params.density * params.nx * params.ny
    assert invariants.total_density(f) == pytest.approx(expected, rel=1e-5)
    # Distributions stay positive for these parameter ranges.
    assert float(jnp.min(f)) > 0.0


def test_all_obstacle_row_scene():
    """A scene whose driven row is fully blocked: accel must be a no-op and
    the state must stay at rest equilibrium."""
    params = LBMParams(nx=16, ny=16, max_iters=5, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    mask = np.zeros((16, 16), dtype=bool)
    mask[params.accel_row, :] = True
    f, av = oracle.run(params, mask, num_steps=5)
    np.testing.assert_allclose(av, 0.0, atol=1e-7)
    f0 = lattice.equilibrium_rest(params.density, 16, 16)
    np.testing.assert_allclose(f, f0, atol=1e-7)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_sync_matches_single_on_random_scenes(seed, shards):
    """Random obstacle geometry (including cells straddling shard
    boundaries): sync sharding must stay bitwise-equal to single device."""
    import jax

    from lbm_tpu.parallel import mesh as mesh_lib
    from lbm_tpu.parallel import modes

    params, mask = _random_scene(seed + 100)
    # Make row count shard-compatible without walls (exercise the
    # no-padding path): crop to a multiple of `shards`.
    ny = (params.ny // shards) * shards
    if ny < 2 * shards:
        ny = 2 * shards
    params = params.replace(ny=ny)
    mask = np.resize(mask, (ny, params.nx))

    single = modes.build_single_program(params, mask)
    f_s = single.init_state
    step_s = jax.jit(single.step)
    for _ in range(10):
        f_s, _ = step_s(f_s)

    mesh = mesh_lib.make_row_mesh(shards)
    prog = modes.build_sharded_program(params, mask, mesh, mode="sync")
    st = prog.init_state
    step = jax.jit(prog.step)
    for _ in range(10):
        st, _ = step(st)
    np.testing.assert_array_equal(np.asarray(prog.f_of(st)), np.asarray(f_s))


@pytest.mark.parametrize("seed", range(6))
def test_block_kernel_matches_jnp_on_random_scenes(seed):
    """Fuzz the Triton block kernel (Pallas interpreter) against the XLA
    step on random geometries, widths that are no power of two, tiles that
    do not divide the grid, and random parameters, over several steps."""
    from lbm_tpu.ops import fused_pallas

    rng = np.random.default_rng(1000 + seed)
    ny = int(rng.choice([9, 16, 24, 37]))
    nx = int(rng.choice([12, 40, 100, 130]))
    block = (int(rng.choice([4, 8, 16])), int(rng.choice([16, 32, 64])), 4)
    params = LBMParams(
        nx=nx, ny=ny, max_iters=5, reynolds_dim=10,
        density=float(rng.uniform(0.05, 0.3)),
        accel=float(rng.uniform(0.001, 0.01)),
        omega=float(rng.uniform(0.8, 1.9)),
    )
    mask = rng.random((ny, nx)) < rng.uniform(0.0, 0.25)
    mask[ny // 2, nx // 2] = False

    obst = jnp.asarray(mask)
    f = jnp.asarray(lattice.equilibrium_rest(params.density, ny, nx))
    g = f
    step = fused_pallas.make_step(params, mask, block=block, interpret=True)
    for _ in range(params.max_iters):
        f, tu_ref = fused_jnp.fused_step_single(f, obst, params)
        g, tu = step(g)
        np.testing.assert_allclose(float(tu), float(tu_ref), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(g), np.asarray(f), atol=1e-7)


@pytest.mark.parametrize("seed", range(5))
def test_ca_matches_sync_on_random_scenes(seed):
    """Random geometry and parameters: the communication-avoiding mode
    must match sync bitwise at a random exchange depth (walls or open wrap
    seam decided by the draw)."""
    import jax

    from lbm_tpu.parallel import mesh as mesh_lib
    from lbm_tpu.parallel import modes

    rng = np.random.default_rng(3000 + seed)
    shards = int(rng.choice([2, 4]))
    nloc = int(rng.choice([8, 16]))
    ny = shards * nloc
    K = int(rng.choice([2, 3, 4]))
    params = LBMParams(
        nx=128, ny=ny, max_iters=2 * K, reynolds_dim=10,
        density=float(rng.uniform(0.05, 0.3)),
        accel=float(rng.uniform(0.001, 0.01)),
        omega=float(rng.uniform(0.8, 1.9)),
    )
    mask = rng.random((ny, 128)) < rng.uniform(0.0, 0.25)
    if rng.random() < 0.5:
        mask[0, :] = mask[-1, :] = True  # walled seam; else open wrap
    mask[ny // 2, 64] = False

    mesh = mesh_lib.make_row_mesh(shards)
    ca = modes.build_sharded_program(params, mask, mesh, mode="ca", staleness=K)
    sync = modes.build_sharded_program(params, mask, mesh, mode="sync")

    st_c, st_s = ca.init_state, sync.init_state
    step_c, step_s = jax.jit(ca.step), jax.jit(sync.step)
    for _ in range(params.max_iters // K):
        st_c, _ = step_c(st_c)
        for _ in range(K):
            st_s, _ = step_s(st_s)
    np.testing.assert_array_equal(
        np.asarray(ca.f_of(st_c)), np.asarray(sync.f_of(st_s))
    )
