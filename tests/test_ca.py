"""Communication-avoiding exact mode (``--variant ca``).

One K-deep raw halo exchange per K steps, then K applications of the XLA
slab step (ops/fused_jnp.fused_step_slab) on a slab that shrinks by one row
per side per step: every owned cell goes through the same arithmetic as in
the synchronous discipline, so fields match sync BITWISE; the av series sums
the owned rows of each level in another grouping (rtol 1e-5).
"""

import numpy as np
import pytest

import jax

from lbm_tpu.io.scene import Scene
from lbm_tpu.models.driver import RunConfig, _pick_variant, run_simulation
from lbm_tpu.parallel import mesh as mesh_lib
from lbm_tpu.parallel import modes
from lbm_tpu.params import LBMParams

STEPS = 16


@pytest.fixture(scope="module")
def mesh4():
    return mesh_lib.make_row_mesh(4)


@pytest.fixture(scope="module")
def ca_scene():
    params = LBMParams(
        nx=128, ny=32, max_iters=STEPS, reynolds_dim=10,
        density=0.1, accel=0.005, omega=1.85,
    )
    r = np.random.default_rng(21)
    mask = r.random((32, 128)) < 0.08
    mask[0, :] = mask[-1, :] = True
    return params, mask


def _run(prog, steps=STEPS):
    step = jax.jit(prog.step)
    st = prog.init_state
    tots = []
    for _ in range(steps // prog.steps_per_call):
        st, tu = step(st)
        tots.append(np.atleast_1d(np.asarray(tu, np.float32)))
    return np.asarray(prog.f_of(st)), np.concatenate(tots)


@pytest.mark.parametrize("K", [2, 4])
def test_ca_matches_sync(ca_scene, mesh4, K):
    params, mask = ca_scene
    sync = modes.build_sharded_program(params, mask, mesh4, mode="sync")
    ca = modes.build_sharded_program(
        params, mask, mesh4, mode="ca", staleness=K
    )
    assert ca.steps_per_call == K
    f_sync, tot_sync = _run(sync)
    f_ca, tot_ca = _run(ca)
    np.testing.assert_array_equal(f_ca, f_sync)
    np.testing.assert_allclose(tot_ca, tot_sync, rtol=1e-5)


@pytest.mark.parametrize("K", [2, 3, 4, 8])
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_ca_jnp_engine_bitwise_vs_sync(K, shards):
    """The jnp ca engine over the K x shard-count matrix: 8-row shards at
    8 devices hold exactly K=8 rows (the deepest exchange that maps), and
    the driven row's shard changes with the count."""
    ny, nx = 64, 24
    params = LBMParams(
        nx=nx, ny=ny, max_iters=3 * K, reynolds_dim=10,
        density=0.1, accel=0.01, omega=1.85,
    )
    r = np.random.default_rng(100 * K + shards)
    mask = r.random((ny, nx)) < 0.1
    mask[0, :] = mask[-1, :] = True
    mesh = mesh_lib.make_row_mesh(shards)
    sync = modes.build_sharded_program(params, mask, mesh, mode="sync")
    ca = modes.build_sharded_program(params, mask, mesh, mode="ca", staleness=K)
    assert ca.steps_per_call == K and ca.backend == "jnp"
    f_sync, tot_sync = _run(sync, 3 * K)
    f_ca, tot_ca = _run(ca, 3 * K)
    np.testing.assert_array_equal(f_ca, f_sync)
    np.testing.assert_allclose(tot_ca, tot_sync, rtol=1e-5)


@pytest.mark.parametrize("K", [2, 4])
def test_ca_matches_sync_open_seam(mesh4, K):
    """Regression: NO walls at rows 0 / ny-1, so the periodic wrap seam is
    live fluid and shard 0's deep lower halo must apply the driven-row
    injection (row ny-2 is always among its wrapped rows)."""
    params = LBMParams(
        nx=128, ny=32, max_iters=STEPS, reynolds_dim=10,
        density=0.1, accel=0.005, omega=1.85,
    )
    r = np.random.default_rng(5)
    mask = r.random((32, 128)) < 0.08
    mask[0, :] = mask[-1, :] = False  # open seam: wrap rows are fluid
    sync = modes.build_sharded_program(params, mask, mesh4, mode="sync")
    ca = modes.build_sharded_program(
        params, mask, mesh4, mode="ca", staleness=K
    )
    f_sync, tot_sync = _run(sync)
    f_ca, tot_ca = _run(ca)
    np.testing.assert_array_equal(f_ca, f_sync)
    np.testing.assert_allclose(tot_ca, tot_sync, rtol=1e-5)


def test_ca_i16(ca_scene, mesh4):
    """i16 ca quantizes after every level, like sync-i16 after every step:
    the two agree bitwise, and both sit in the quantization envelope of
    the f32 run."""
    params, mask = ca_scene
    ca = modes.build_sharded_program(
        params, mask, mesh4, mode="ca", staleness=2, storage="i16"
    )
    assert ca.variant == "ca-2-i16"
    f, tots = _run(ca)
    assert np.all(np.isfinite(f)) and np.all(np.isfinite(tots))
    sync16 = modes.build_sharded_program(
        params, mask, mesh4, mode="sync", storage="i16"
    )
    f_s16, _ = _run(sync16)
    np.testing.assert_array_equal(f, f_s16)
    sync = modes.build_sharded_program(params, mask, mesh4, mode="sync")
    f_sync, _ = _run(sync)
    assert np.abs(f - f_sync).max() < 1e-4


def test_ca_arbitrary_step_count_runs_sync_tail(ca_scene):
    # --variant ca --steps 10 with K=4: 8 bulk steps + a 2-step exact sync
    # tail, bitwise continuation of the run.
    params, mask = ca_scene
    scene = Scene(params=params, obstacles=mask)
    res_ca = run_simulation(
        scene,
        RunConfig(variant="ca", num_devices=4, staleness=4, num_steps=10),
    )
    res_sync = run_simulation(
        scene, RunConfig(variant="sync", num_devices=4, num_steps=10)
    )
    assert res_ca.variant == "ca-4+sync-tail2"
    assert res_ca.av_vels.shape == (10,)
    np.testing.assert_array_equal(res_ca.f, res_sync.f)
    np.testing.assert_allclose(res_ca.av_vels, res_sync.av_vels, rtol=1e-5)


def test_ca_steps_below_depth_run_pure_tail(ca_scene):
    # steps < K: no bulk sweeps at all, the whole run is the sync tail.
    params, mask = ca_scene
    scene = Scene(params=params, obstacles=mask)
    res = run_simulation(
        scene,
        RunConfig(variant="ca", num_devices=4, staleness=4, num_steps=3),
    )
    ref = run_simulation(
        scene, RunConfig(variant="sync", num_devices=4, num_steps=3)
    )
    assert res.variant.endswith("+sync-tail3")
    np.testing.assert_array_equal(res.f, ref.f)


def test_chunked_arbitrary_step_count_runs_sync_tail(ca_scene):
    params, mask = ca_scene
    scene = Scene(params=params, obstacles=mask)
    res = run_simulation(
        scene,
        RunConfig(variant="chunked", num_devices=4, staleness=3, num_steps=7),
    )
    assert res.variant.endswith("+sync-tail1")
    assert res.av_vels.shape == (7,)
    assert np.all(np.isfinite(res.av_vels))


def test_auto_prefers_ca_wherever_it_maps():
    """The multi-device auto policy picks the exact comm-avoiding discipline
    wherever it maps — every storage, with or without --debug (debug runs
    decompose into the bitwise-identical sync schedule) — and falls back to
    the stale-fraction async/overlap rule only where it cannot."""
    params = LBMParams(
        nx=2048, ny=8192, max_iters=4, reynolds_dim=10,
        density=0.1, accel=0.005, omega=1.85,
    )
    mask = np.zeros((8192, 2048), dtype=bool)
    mask[0, :] = mask[-1, :] = True
    scene = Scene(params=params, obstacles=mask)
    assert _pick_variant(scene, RunConfig(num_devices=4)) == "ca"
    params_s = params.replace(ny=512, nx=512)
    mask_s = np.zeros((512, 512), dtype=bool)
    mask_s[0, :] = mask_s[-1, :] = True
    scene_s = Scene(params=params_s, obstacles=mask_s)
    assert _pick_variant(scene_s, RunConfig(num_devices=4)) == "ca"
    assert _pick_variant(
        scene_s, RunConfig(num_devices=4, storage="i16", debug=True)
    ) == "ca"
    # Open seam (ny not divisible, fluid seam rows): ca cannot map.
    mask_o = np.zeros((510, 512), dtype=bool)
    scene_o = Scene(params=params_s.replace(ny=510), obstacles=mask_o)
    assert _pick_variant(scene_o, RunConfig(num_devices=4)) in (
        "async", "overlap"
    )


def test_ca_supported_mirrors_build_gate(ca_scene, mesh4):
    params, mask = ca_scene
    assert modes.ca_supported(mask, 4, staleness=2)
    assert modes.ca_supported(mask, 4, staleness=8)  # 8-row shards, K=8
    assert not modes.ca_supported(mask, 4, staleness=9)
    tiny_mask = np.zeros((8, 128), dtype=bool)
    tiny_mask[0, :] = tiny_mask[-1, :] = True
    # 2-row shards: K=2 maps, K=4 does not — predicate and build agree.
    assert modes.ca_supported(tiny_mask, 4, staleness=2)
    assert not modes.ca_supported(tiny_mask, 4, staleness=4)
    tiny = params.replace(ny=8)
    modes.build_sharded_program(tiny, tiny_mask, mesh4, mode="ca", staleness=2)
    with pytest.raises(ValueError):
        modes.build_sharded_program(
            tiny, tiny_mask, mesh4, mode="ca", staleness=4
        )


def test_ca_label_reports_effective_depth(ca_scene, mesh4):
    # --staleness 1 still runs a ca_depth(1)=2 schedule; the label must say
    # the depth actually executed.
    params, mask = ca_scene
    ca = modes.build_sharded_program(
        params, mask, mesh4, mode="ca", staleness=1
    )
    assert ca.variant == "ca-2"
    assert ca.steps_per_call == 2


def test_ca_rejects_unmappable_shards(mesh4):
    # 8 rows over 4 shards -> 2-row shards: a 4-deep exchange cannot map.
    params = LBMParams(
        nx=128, ny=8, max_iters=4, reynolds_dim=10,
        density=0.1, accel=0.005, omega=1.85,
    )
    mask = np.zeros((8, 128), dtype=bool)
    mask[0, :] = mask[-1, :] = True
    with pytest.raises(ValueError, match="ca mode exchanges K=4 rows"):
        modes.build_sharded_program(params, mask, mesh4, mode="ca", staleness=4)


def test_ca_driver_end_to_end(ca_scene):
    params, mask = ca_scene
    scene = Scene(params=params, obstacles=mask)
    res_ca = run_simulation(
        scene, RunConfig(variant="ca", num_devices=4, staleness=4)
    )
    res_sync = run_simulation(
        scene, RunConfig(variant="sync", num_devices=4)
    )
    assert res_ca.variant == "ca-4"
    np.testing.assert_array_equal(res_ca.f, res_sync.f)
    np.testing.assert_allclose(res_ca.av_vels, res_sync.av_vels, rtol=1e-5)


def test_ca_lane_padded_grid(mesh4):
    """ca on a width that is no multiple of anything in particular: the XLA
    slab step takes any width, and the run still matches sync."""
    params = LBMParams(
        nx=100, ny=32, max_iters=8, reynolds_dim=10,
        density=0.1, accel=0.005, omega=1.85,
    )
    r = np.random.default_rng(31)
    mask = r.random((32, 100)) < 0.08
    mask[0, :] = mask[-1, :] = True
    sync = modes.build_sharded_program(params, mask, mesh4, mode="sync")
    ca = modes.build_sharded_program(
        params, mask, mesh4, mode="ca", staleness=2
    )
    f_sync, tot_sync = _run(sync, steps=8)
    f_ca, tot_ca = _run(ca, steps=8)
    np.testing.assert_array_equal(f_ca, f_sync)
    np.testing.assert_allclose(tot_ca, tot_sync, rtol=1e-5)


@pytest.mark.parametrize("storage", ["f32", "i16"])
def test_ca_debug_runs_sync_decomposition(ca_scene, capsys, storage):
    """--debug with ca: per-step observables come from the bitwise-identical
    sync schedule; av_vels match the plain ca run and densities are printed
    for every step.  i16 too: ca-i16 quantizes after every level, exactly
    like sync-i16."""
    params, mask = ca_scene
    scene = Scene(params=params, obstacles=mask)
    base = run_simulation(
        scene,
        RunConfig(variant="ca", num_devices=4, staleness=4, num_steps=8,
                  storage=storage),
    )
    with pytest.warns(UserWarning, match="bitwise-identical sync schedule"):
        res = run_simulation(
            scene,
            RunConfig(
                variant="ca", num_devices=4, staleness=4, num_steps=8,
                debug=True, storage=storage,
            ),
        )
    out = capsys.readouterr().out
    assert out.count("==timestep:") == 8
    assert out.count("tot density:") == 8
    assert res.variant == "ca-4+debug-as-sync"
    np.testing.assert_array_equal(res.f, base.f)
    np.testing.assert_allclose(res.av_vels, base.av_vels, rtol=1e-5)


def test_plan_notes_ca_debug(ca_scene):
    from lbm_tpu.models.plan import describe_plan

    params, mask = ca_scene
    scene = Scene(params=params, obstacles=mask)
    for storage in ("f32", "i16"):
        plan = describe_plan(scene, RunConfig(
            variant="ca", num_devices=4, staleness=4, num_steps=8,
            debug=True, storage=storage,
        ))
        assert "bitwise-identical sync schedule" in plan
        assert "will FAIL" not in plan


def test_auto_with_jnp_backend_picks_ca():
    """ca always runs the XLA step, so an explicit --backend jnp keeps it
    in the auto policy, and the pick builds."""
    from lbm_tpu.models.driver import build_program

    params = LBMParams(
        nx=64, ny=64, max_iters=4, reynolds_dim=10,
        density=0.1, accel=0.005, omega=1.85,
    )
    mask = np.zeros((64, 64), dtype=bool)
    mask[0, :] = mask[-1, :] = True
    scene = Scene(params=params, obstacles=mask)
    cfg = RunConfig(num_devices=4, backend="jnp")
    assert _pick_variant(scene, cfg) == "ca"
    prog = build_program(scene, cfg)
    assert prog.backend == "jnp" and prog.variant == "ca-4"


@pytest.mark.parametrize("storage", ["f32", "i16"])
def test_ca_frames_match_plain_run(ca_scene, storage):
    """Frame capture on ca advances through the ca step and sync
    micro-steps for segments that are not whole sweeps; both storages
    reproduce the plain run's fields bitwise."""
    params, mask = ca_scene
    scene = Scene(params=params, obstacles=mask)
    cfg = dict(variant="ca", num_devices=4, staleness=4, num_steps=10,
               storage=storage)
    plain = run_simulation(scene, RunConfig(**cfg))
    framed = run_simulation(scene, RunConfig(**cfg, frame_interval=3))
    assert framed.frames.shape == (4, 32, 128)
    np.testing.assert_array_equal(framed.f, plain.f)
    np.testing.assert_allclose(framed.av_vels, plain.av_vels, rtol=1e-5)


def test_auto_i16_frames_picks_ca(ca_scene):
    """Multi-device i16 runs with --frame-interval: auto picks ca (i16 ca
    decomposes per step exactly) and the run succeeds end-to-end."""
    params, mask = ca_scene
    scene = Scene(params=params, obstacles=mask)
    cfg = RunConfig(
        num_devices=4, storage="i16", frame_interval=4, num_steps=8
    )
    assert _pick_variant(scene, cfg) == "ca"
    res = run_simulation(scene, cfg)
    assert res.frames is not None and res.frames.shape[0] == 2
    assert np.all(np.isfinite(res.av_vels))


def test_ca_walled_row_padding_matches_sync():
    """15 walled rows over 2 shards pad to 16 (blocked padding rows): ca
    maps on the padded grid and matches sync."""
    params = LBMParams(
        nx=128, ny=15, max_iters=8, reynolds_dim=10,
        density=0.1, accel=0.005, omega=1.85,
    )
    mask = np.zeros((15, 128), dtype=bool)
    mask[0, :] = mask[-1, :] = True  # walled seam: blocked row padding
    assert modes.ca_supported(mask, 2, staleness=4)
    mesh2 = mesh_lib.make_row_mesh(2)
    ca = modes.build_sharded_program(params, mask, mesh2, mode="ca", staleness=4)
    sync = modes.build_sharded_program(params, mask, mesh2, mode="sync")
    f_ca, tot_ca = _run(ca, steps=8)
    f_sync, tot_sync = _run(sync, steps=8)
    np.testing.assert_array_equal(f_ca, f_sync)
    np.testing.assert_allclose(tot_ca, tot_sync, rtol=1e-5)


def test_ca_default_depth_in_run_label():
    """run_simulation without --staleness runs the K=4 default and carries
    it into the variant label (and the run still matches sync bitwise)."""
    params = LBMParams(
        nx=128, ny=192, max_iters=8, reynolds_dim=10,
        density=0.1, accel=0.005, omega=1.85,
    )
    mask = np.zeros((192, 128), dtype=bool)
    mask[0, :] = mask[-1, :] = True
    scene = Scene(params=params, obstacles=mask)
    res = run_simulation(
        scene, RunConfig(variant="ca", num_devices=2, num_steps=8)
    )
    assert res.variant == "ca-4"
    res_sync = run_simulation(
        scene, RunConfig(variant="sync", num_devices=2, num_steps=8)
    )
    np.testing.assert_array_equal(res.f, res_sync.f)


def test_plan_names_ca_engine(ca_scene):
    from lbm_tpu.models.plan import describe_plan

    params, mask = ca_scene
    scene = Scene(params=params, obstacles=mask)
    plan = describe_plan(scene, RunConfig(
        variant="ca", num_devices=4, staleness=4, num_steps=8,
    ))
    assert "ca: 4 steps per exchange on a slab shrinking from 8+2x4" in plan
    assert "per-shard step: XLA-fused step" in plan
    # A depth deeper than the shards predicts failure.
    plan2 = describe_plan(scene, RunConfig(
        variant="ca", num_devices=4, staleness=9, num_steps=9,
    ))
    assert "will FAIL" in plan2


def test_build_init_false_skips_init_state(ca_scene, mesh4):
    """Auxiliary step-only programs skip the init-state allocation."""
    params, mask = ca_scene
    prog = modes.build_sharded_program(
        params, mask, mesh4, mode="sync", build_init=False
    )
    assert prog.init_state is None
    # Its step still works when lowered against a live state.
    full = modes.build_sharded_program(params, mask, mesh4, mode="sync")
    f1_aux, _ = jax.jit(prog.step)(full.init_state)
    f1_full, _ = jax.jit(full.step)(full.init_state)
    np.testing.assert_array_equal(np.asarray(f1_aux), np.asarray(f1_full))
    # Ghost-carrying modes cannot skip the init state.
    with pytest.raises(ValueError, match="bare-f"):
        modes.build_sharded_program(
            params, mask, mesh4, mode="chunked", build_init=False
        )
