"""Constant hoisting in the driver's jit boundary (driver._HoistedJit).

The kernel factories bake geometry (obstacle layouts, seam strips) into jnp
constants; the driver hoists those out of the traced program and passes them
as runtime arguments so lowered modules are geometry-independent and very
large grids stay under the remote-compile request-size limit.  These tests
pin (a) bitwise equality against the plain embedded-constant jit, (b) that
the hoisted module really does shed the obstacle-sized constants, and (c)
that the sharded path still matches the single-device result when hoisted
(the suite's other sharded tests all run through the same driver boundary).
"""

import numpy as np
import pytest

import jax

from lbm_tpu.models import driver
from lbm_tpu.parallel import modes


def _program(params, obstacles, backend):
    return modes.build_single_program(params, obstacles, backend=backend)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_hoisted_matches_embedded_jit(small_params, small_obstacles, backend):
    if backend == "pallas":
        # the block kernel in the Pallas interpreter (no GPU here)
        prog = modes.build_single_program(
            small_params, small_obstacles, backend="pallas", interpret=True
        )
    else:
        prog = _program(small_params, small_obstacles, backend)
    run = driver._make_scan(prog, 12, None)
    assert isinstance(run, driver._HoistedJit)
    state = prog.init_state
    f_h, tot_h, _ = run(state)
    # plain jit of the same closure: constants embedded
    f_p, tot_p, _ = jax.jit(run._run)(state)
    np.testing.assert_array_equal(np.asarray(f_h), np.asarray(f_p))
    np.testing.assert_array_equal(np.asarray(tot_h), np.asarray(tot_p))


def test_hoisted_module_sheds_grid_constants(small_params, small_obstacles):
    prog = _program(small_params, small_obstacles, "jnp")
    run = driver._make_scan(prog, 8, None)
    state = prog.init_state
    jrun, consts = run._built or run._build(state)
    # the obstacle mask (ny, nx) must be among the hoisted constants
    shapes = {np.shape(c) for c in consts}
    ny, nx = small_params.ny, small_params.nx
    assert any(s[-2:] == (ny, nx) for s in shapes if len(s) >= 2), shapes
    hoisted = jrun.lower(consts, *jax.tree.leaves(state)).as_text()
    plain = jax.jit(run._run).lower(state).as_text()
    assert len(hoisted) < len(plain)


def test_hoisted_lower_compile_contract(small_params, small_obstacles):
    prog = _program(small_params, small_obstacles, "jnp")
    run = driver._make_scan(prog, 6, None)
    state = prog.init_state
    compiled = run.lower(state).compile()
    f_c, tot_c, _ = compiled(state)
    f_e, tot_e, _ = run(state)
    np.testing.assert_array_equal(np.asarray(f_c), np.asarray(f_e))
    np.testing.assert_array_equal(np.asarray(tot_c), np.asarray(tot_e))


def test_hoisted_sharded_sync_matches_single(small_params, small_obstacles):
    from lbm_tpu.parallel import mesh as mesh_lib

    params = small_params.replace(max_iters=12)
    mesh = mesh_lib.make_row_mesh(2)
    sharded = modes.build_sharded_program(
        params, small_obstacles, mesh, mode="sync"
    )
    single = modes.build_single_program(params, small_obstacles, backend="jnp")
    run_s = driver._make_scan(sharded, 12, None)
    run_1 = driver._make_scan(single, 12, None)
    out_s, tot_s, _ = run_s(sharded.init_state)
    out_1, tot_1, _ = run_1(single.init_state)
    f_s = np.asarray(jax.device_get(sharded.f_of(out_s)))
    f_1 = np.asarray(jax.device_get(single.f_of(out_1)))
    np.testing.assert_array_equal(f_s[:, : params.ny, :], f_1)
