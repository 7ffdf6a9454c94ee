"""Driver (scan loop, frames, timing) and variant registry tests."""

import numpy as np
import pytest

from lbm_tpu.core import lattice, oracle
from lbm_tpu.io.scene import Scene
from lbm_tpu.models import RunConfig, run_simulation, resolve_variant
from lbm_tpu.models.variants import VARIANTS


@pytest.fixture
def scene(small_params, small_obstacles):
    return Scene(params=small_params.replace(max_iters=30), obstacles=small_obstacles)


def test_variant_registry_covers_reference_ladder():
    analogs = {v.reference_analog.split("/")[0] for v in VARIANTS.values()}
    for ref_dir in (
        "SerialCode",
        "OpenMP",
        "MPI",
        "MPI_Waitall",
        "MPI_Testall_OptimizedVersion",
        "MPI_Testall_ComplexVersion",
    ):
        assert any(ref_dir in v.reference_analog for v in VARIANTS.values()), ref_dir
    assert resolve_variant("testall") == "async"
    assert resolve_variant("openmp") == "jnp"
    with pytest.raises(ValueError):
        resolve_variant("nope")


def test_driver_jnp_matches_oracle(scene):
    result = run_simulation(scene, RunConfig(variant="jnp"))
    f_o, av_o = oracle.run(scene.params, scene.obstacles)
    np.testing.assert_allclose(result.f, f_o, atol=2e-7)
    np.testing.assert_allclose(result.av_vels, av_o, rtol=1e-4)
    assert result.timer.elapsed["compute"] > 0
    assert np.isfinite(result.reynolds)


def test_zero_steps_returns_empty_series(scene):
    # num_steps=0 must return the untouched init state and an empty av_vels
    # series, not crash on an empty segment list.
    result = run_simulation(scene, RunConfig(variant="jnp", num_steps=0))
    assert result.av_vels.shape == (0,)
    f0 = lattice.equilibrium_rest(
        scene.params.density, scene.params.ny, scene.params.nx
    )
    np.testing.assert_array_equal(result.f, f0)


def test_zero_steps_with_debug(scene):
    # --debug at num_steps=0: nothing to observe, but no crash either
    # (the debug collate used to index an empty segment list).
    result = run_simulation(
        scene, RunConfig(variant="jnp", num_steps=0, debug=True)
    )
    assert result.av_vels.shape == (0,)


def test_driver_serial_variant(scene):
    result = run_simulation(scene, RunConfig(variant="serial"))
    f_o, av_o = oracle.run(scene.params, scene.obstacles)
    np.testing.assert_array_equal(result.f, f_o)
    np.testing.assert_array_equal(result.av_vels, av_o)


def test_driver_sharded(scene):
    # backend pinned to jnp: this tests the driver's discipline plumbing
    # bitwise; pallas-vs-jnp equivalence (1 ulp on CPU interpret) is covered
    # by test_pallas_backend_all_modes.
    ref = run_simulation(scene, RunConfig(variant="jnp"))
    for variant in ("sync", "overlap"):
        res = run_simulation(
            scene, RunConfig(variant=variant, num_devices=8, backend="jnp")
        )
        np.testing.assert_array_equal(res.f, ref.f)
    res = run_simulation(
        scene, RunConfig(variant="async", num_devices=8, backend="jnp")
    )
    rel = np.abs(res.f - ref.f).max() / np.abs(ref.f).max()
    assert rel < 1e-2


def test_driver_frames(scene):
    result = run_simulation(
        scene, RunConfig(variant="jnp", frame_interval=10)
    )
    assert result.frames is not None
    assert result.frames.shape == (3, scene.params.ny, scene.params.nx)
    np.testing.assert_array_equal(result.frame_steps, [0, 10, 20])
    # Frames are |u| with obstacles zeroed; frame 0 is the state after the
    # first step: driven row has moved, so non-zero somewhere.
    assert result.frames[0][scene.obstacles].max() == 0.0
    assert result.frames[-1].max() > 0.0
    # Later frames show more developed flow.
    assert result.frames[-1].max() >= result.frames[0].max()


def test_driver_frames_sharded(scene):
    ref = run_simulation(scene, RunConfig(variant="jnp", frame_interval=10))
    res = run_simulation(
        scene,
        RunConfig(variant="sync", num_devices=8, frame_interval=10, backend="jnp"),
    )
    np.testing.assert_array_equal(res.frames, ref.frames)


def _kernel_scene(ny, nx, steps, seed=31):
    from lbm_tpu.params import LBMParams

    params = LBMParams(
        nx=nx, ny=ny, max_iters=steps, reynolds_dim=10,
        density=0.1, accel=0.005, omega=1.85,
    )
    r = np.random.default_rng(seed)
    mask = r.random((ny, nx)) < 0.08
    mask[0, :] = mask[-1, :] = True
    return Scene(params=params, obstacles=mask)


def test_frames_on_block_kernel():
    """Frame capture through the block kernel (Pallas interpreter): frames,
    fields and av_vels match the per-step XLA path at the same steps (the
    interpreter and XLA's CPU fusion may round differently in the last
    bit)."""
    sc = _kernel_scene(32, 128, steps=25)
    ref = run_simulation(sc, RunConfig(variant="jnp", frame_interval=10))
    res = run_simulation(
        sc, RunConfig(variant="pallas", frame_interval=10, interpret=True)
    )
    assert res.variant == "pallas"
    np.testing.assert_array_equal(res.frame_steps, ref.frame_steps)
    np.testing.assert_allclose(res.frames, ref.frames, atol=5e-7)
    np.testing.assert_allclose(res.av_vels, ref.av_vels, rtol=1e-4)
    np.testing.assert_allclose(res.f, ref.f, atol=5e-7)


def test_frames_on_block_kernel_any_width():
    """A width that is no power of two (masked tail tiles) and an interval
    that does not divide the run: the capture scan's partial last segment."""
    sc = _kernel_scene(32, 100, steps=23)
    ref = run_simulation(sc, RunConfig(variant="jnp", frame_interval=7))
    res = run_simulation(
        sc, RunConfig(variant="pallas", frame_interval=7, interpret=True)
    )
    np.testing.assert_array_equal(res.frame_steps, ref.frame_steps)
    np.testing.assert_allclose(res.frames, ref.frames, atol=5e-7)
    np.testing.assert_allclose(res.f, ref.f, atol=5e-7)


def test_frames_on_ca_variant():
    """ca frame capture (previously rejected): inter-frame segments run as
    whole K-chunks plus exact sync micro-steps; frames match the sync
    per-step path at matching steps."""
    sc = _kernel_scene(32, 128, steps=25)
    ref = run_simulation(
        sc,
        RunConfig(variant="sync", num_devices=4, frame_interval=10),
    )
    res = run_simulation(
        sc,
        RunConfig(variant="ca", num_devices=4, staleness=4, frame_interval=10),
    )
    assert res.frames.shape == ref.frames.shape
    np.testing.assert_array_equal(res.frame_steps, ref.frame_steps)
    np.testing.assert_allclose(res.frames, ref.frames, atol=5e-7)
    np.testing.assert_allclose(res.f, ref.f, atol=5e-7)
    np.testing.assert_allclose(res.av_vels, ref.av_vels, rtol=1e-4)


@pytest.mark.parametrize("variant", ["jnp", "pallas"])
def test_frames_i16_storage(variant):
    sc = _kernel_scene(32, 128, steps=20)
    ref = run_simulation(sc, RunConfig(variant="jnp", frame_interval=10))
    res = run_simulation(
        sc,
        RunConfig(variant=variant, storage="i16", frame_interval=10,
                  interpret=True),
    )
    assert res.variant == f"{variant}-i16"
    np.testing.assert_allclose(res.frames, ref.frames, atol=1e-3)


def test_chunk_primitives_compose_to_whole_chunk():
    """k frozen-ghost inner steps + one exchange must be bitwise the
    whole-chunk step() (the decomposition the frame path advances by)."""
    import jax

    from lbm_tpu.parallel import mesh as mesh_lib
    from lbm_tpu.parallel import modes

    sc = _kernel_scene(32, 128, steps=8)
    mesh = mesh_lib.make_row_mesh(4)
    prog = modes.build_sharded_program(
        sc.params, sc.obstacles, mesh, mode="chunked", staleness=3,
        backend="jnp",
    )
    s_whole, tots = jax.jit(prog.step)(prog.init_state)
    inner = jax.jit(prog.chunk_inner_step)
    exch = jax.jit(prog.chunk_exchange)
    s = prog.init_state
    parts = []
    for _ in range(3):
        s, tu = inner(s)
        parts.append(np.asarray(tu))
    s = exch(s)
    for a, b in zip(jax.tree.leaves(s_whole), jax.tree.leaves(s)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(parts), np.asarray(tots))


def test_frames_on_chunked_variant():
    """Chunked frame capture (previously rejected): capture points land
    mid-chunk by splitting the chunk into its inner steps, with exchanges at
    the same schedule positions — so the frames run reproduces the
    no-frames chunked run exactly and frames land at the standard steps."""
    sc = _kernel_scene(32, 128, steps=24)
    base = run_simulation(sc, RunConfig(
        variant="chunked", num_devices=4, staleness=2, backend="jnp",
    ))
    res = run_simulation(sc, RunConfig(
        variant="chunked", num_devices=4, staleness=2, backend="jnp",
        frame_interval=10,
    ))
    np.testing.assert_array_equal(res.f, base.f)
    np.testing.assert_array_equal(res.av_vels, base.av_vels)
    assert list(res.frame_steps) == [0, 10, 20]
    assert res.frames.shape == (3, 32, 128)
    # And the frames themselves are the chunked schedule's states: they
    # deviate from the sync per-step path (stale ghosts) but only boundedly.
    ref = run_simulation(sc, RunConfig(
        variant="sync", num_devices=4, backend="jnp", frame_interval=10,
    ))
    assert np.max(np.abs(res.frames - ref.frames)) < 1e-2
    assert not np.array_equal(res.frames, ref.frames)


def test_frames_chunked_pallas_and_i16():
    """Chunked frames under the block kernel's slab form (Pallas
    interpreter) and under i16 storage: the primitive-decomposed frames run
    must still reproduce the no-frames run exactly."""
    sc = _kernel_scene(64, 128, steps=16)
    with pytest.warns(UserWarning):  # high stale-row exposure advisory
        kw = dict(variant="chunked", num_devices=4, staleness=2,
                  backend="pallas", interpret=True)
        base = run_simulation(sc, RunConfig(**kw))
        res = run_simulation(sc, RunConfig(**kw, frame_interval=8))
        base16 = run_simulation(sc, RunConfig(**kw, storage="i16"))
        res16 = run_simulation(sc, RunConfig(
            **kw, storage="i16", frame_interval=8,
        ))
    np.testing.assert_array_equal(res.f, base.f)
    np.testing.assert_array_equal(res.av_vels, base.av_vels)
    np.testing.assert_array_equal(res16.f, base16.f)
    np.testing.assert_array_equal(res16.av_vels, base16.av_vels)
    assert res.frames.shape == res16.frames.shape == (2, 64, 128)


def test_debug_on_chunked_variant(capsys):
    """--debug with chunked (previously rejected): per-step av velocity and
    total density sampled through the chunk primitives, schedule unchanged
    (final state bitwise vs the no-debug run), remainder steps handled."""
    sc = _kernel_scene(32, 128, steps=11)  # 5 chunks of 2 + remainder 1
    base = run_simulation(sc, RunConfig(
        variant="chunked", num_devices=4, staleness=2, backend="jnp",
        num_steps=10,
    ))
    res = run_simulation(sc, RunConfig(
        variant="chunked", num_devices=4, staleness=2, backend="jnp",
        num_steps=11, debug=True,
    ))
    out = capsys.readouterr().out
    assert out.count("==timestep:") == 11
    assert out.count("tot density:") == 11
    assert res.av_vels.shape == (11,)
    # First 10 steps of the debug run reproduce the plain chunked run.
    np.testing.assert_array_equal(res.av_vels[:10], base.av_vels)
    # Density stays conserved (periodic + bounce-back walls).
    import re

    dens = [float(m) for m in re.findall(r"tot density: ([0-9.E+-]+)", out)]
    np.testing.assert_allclose(dens, dens[0], rtol=1e-5)


def test_chunked_frames_and_debug_match_plain_at_remainder():
    """Review r3: a chunked run whose step count leaves a >=2-step remainder
    must produce IDENTICAL results with --frame-interval / --debug as
    without — the remainder runs as fresh-ghost (sync) steps in all three
    paths, not as frozen-ghost inners.  staleness=3, steps=11 -> remainder 2;
    the last mid frame segment crosses the sync-tail boundary."""
    sc = _kernel_scene(32, 128, steps=11)
    kw = dict(variant="chunked", num_devices=4, staleness=3, backend="jnp")
    base = run_simulation(sc, RunConfig(**kw))
    assert base.variant == "chunked-3+sync-tail2"
    fr = run_simulation(sc, RunConfig(**kw, frame_interval=3))
    dbg = run_simulation(sc, RunConfig(**kw, debug=True))
    np.testing.assert_array_equal(fr.f, base.f)
    np.testing.assert_array_equal(fr.av_vels, base.av_vels)
    np.testing.assert_array_equal(dbg.f, base.f)
    np.testing.assert_array_equal(dbg.av_vels, base.av_vels)
    # Frames still land at the per-step path's capture points.
    ref = run_simulation(sc, RunConfig(variant="sync", num_devices=4,
                                       frame_interval=3))
    assert fr.frames.shape == ref.frames.shape == (4, 32, 128)


def test_chunked_i16_remainder_matches_plain():
    """Same contract under i16 storage (quantized carry crosses the
    exchange/tail boundary)."""
    sc = _kernel_scene(32, 128, steps=11)
    kw = dict(variant="chunked", num_devices=4, staleness=3, storage="i16")
    base = run_simulation(sc, RunConfig(**kw))
    fr = run_simulation(sc, RunConfig(**kw, frame_interval=3))
    np.testing.assert_array_equal(fr.f, base.f)
    np.testing.assert_array_equal(fr.av_vels, base.av_vels)


def test_open_seam_chunked_frames_and_debug_match_plain():
    """Open-seam-padded chunked shards (ny not divisible, fluid wrap rows)
    now decompose too: frames/debug runs are bitwise-identical to the plain
    run, remainder included."""
    from lbm_tpu.params import LBMParams

    params = LBMParams(nx=128, ny=30, max_iters=11, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    r = np.random.default_rng(7)
    mask = r.random((30, 128)) < 0.08
    mask[0, :] = mask[-1, :] = False  # open seam
    sc = Scene(params=params, obstacles=mask)
    kw = dict(variant="chunked", num_devices=4, staleness=3, backend="jnp")
    with pytest.warns(UserWarning):  # stale-row exposure advisory
        base = run_simulation(sc, RunConfig(**kw))
        fr = run_simulation(sc, RunConfig(**kw, frame_interval=3))
        dbg = run_simulation(sc, RunConfig(**kw, debug=True))
    np.testing.assert_array_equal(fr.f, base.f)
    np.testing.assert_array_equal(fr.av_vels, base.av_vels)
    np.testing.assert_array_equal(dbg.f, base.f)
    np.testing.assert_array_equal(dbg.av_vels, base.av_vels)
    assert fr.frames.shape == (4, 30, 128)  # pad rows cropped


def test_frames_chunked_interval_must_align():
    sc = _kernel_scene(32, 128, steps=24)
    with pytest.raises(ValueError, match="multiple of the 4-step chunk"):
        run_simulation(
            sc,
            RunConfig(
                variant="chunked", num_devices=4, staleness=4,
                frame_interval=10,
            ),
        )


def test_mlups_metric(scene):
    result = run_simulation(scene, RunConfig(variant="jnp"))
    assert result.mlups > 0


def test_driver_frames_sharded_indivisible(scene):
    """ADVICE r1 (medium): frames + sharded variant on ny not divisible by
    the device count must work — buffer allocated at the padded extents and
    cropped back to the user grid."""
    ref = run_simulation(scene, RunConfig(variant="jnp", frame_interval=10))
    res = run_simulation(
        scene,
        RunConfig(variant="sync", num_devices=3, frame_interval=10, backend="jnp"),
    )
    assert res.frames.shape == ref.frames.shape
    np.testing.assert_array_equal(res.frames, ref.frames)


def test_serial_rejects_checkpointing(scene):
    """ADVICE r1: serial + resume/checkpoint must raise, not silently ignore."""
    with pytest.raises(ValueError, match="serial"):
        run_simulation(scene, RunConfig(variant="serial", resume_from="x.npz"))
    with pytest.raises(ValueError, match="serial"):
        run_simulation(scene, RunConfig(variant="serial", checkpoint_every=10))


def test_resumed_mlups_counts_only_new_steps(scene, tmp_path):
    """ADVICE r1: MLUPS on resumed runs must use steps computed this run."""
    ck_dir = tmp_path / "ck"
    run_simulation(
        scene,
        RunConfig(variant="jnp", checkpoint_every=10, checkpoint_dir=str(ck_dir)),
    )
    ck = sorted(ck_dir.glob("ckpt_*.npz"))[0]  # step 10 of 30
    res = run_simulation(scene, RunConfig(variant="jnp", resume_from=str(ck)))
    assert len(res.av_vels) == 30
    assert res.steps_computed == 20
    cells = scene.params.ny * scene.params.nx
    expected = cells * 20 / res.timer.elapsed["compute"] / 1e6
    assert res.mlups == pytest.approx(expected)


def test_auto_uses_mesh_when_multi_device(small_params, small_obstacles):
    """Auto on a multi-device host picks a sharded variant — the exact
    comm-avoiding discipline wherever it maps, else async when the
    stale-fraction model keeps deviation well inside the 1% contract, the
    bitwise-exact overlap discipline otherwise."""
    from lbm_tpu.io.scene import Scene
    from lbm_tpu.models.driver import _pick_variant

    # 16 rows over 8 devices: 2-row shards cannot hold a 4-deep exchange,
    # and 100% stale-row exposure rules async out -> exact overlap.
    scene = Scene(params=small_params, obstacles=small_obstacles)
    assert _pick_variant(scene, RunConfig()) == "overlap"
    # 2048 rows over 8 devices: ca maps at any width -> the exact
    # amortized discipline, whatever the per-step backend.
    big = small_params.replace(ny=2048, nx=16)
    scene_big = Scene(
        params=big, obstacles=np.zeros((2048, 16), dtype=bool)
    )
    assert _pick_variant(scene_big, RunConfig()) == "ca"
    assert _pick_variant(scene_big, RunConfig(backend="jnp")) == "ca"
    # Open seam (2047 rows: padding with fluid seam rows): ca cannot map;
    # ~0.8% exposure (~0.1% deviation) -> async.
    odd = Scene(
        params=big.replace(ny=2047), obstacles=np.zeros((2047, 16), dtype=bool)
    )
    assert _pick_variant(odd, RunConfig()) == "async"
    # Explicit single device keeps the single-device policy: the XLA step
    # on a CPU.
    assert _pick_variant(scene, RunConfig(num_devices=1)) == "jnp"


@pytest.mark.parametrize("mode", ["sync", "ca"])
def test_sharded_backend_defaults_by_platform(monkeypatch, mode):
    """Sharded modes take the auto backend: the XLA step on a CPU, the
    block kernel on a GPU (the platform is all the policy reads)."""
    import jax

    from lbm_tpu.params import LBMParams
    from lbm_tpu.parallel import mesh as mesh_lib
    from lbm_tpu.parallel import modes

    params = LBMParams(nx=128, ny=32, max_iters=4, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    mask = np.zeros((32, 128), dtype=bool)
    mask[0, :] = mask[-1, :] = True
    prog = modes.build_sharded_program(
        params, mask, mesh_lib.make_row_mesh(2), mode=mode
    )
    assert prog.backend == "jnp"
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    prog = modes.build_sharded_program(
        params, mask, mesh_lib.make_row_mesh(2), mode=mode
    )
    assert prog.backend == "pallas"
    forced = modes.build_sharded_program(
        params, mask, mesh_lib.make_row_mesh(2), mode="sync", backend="jnp"
    )
    assert forced.backend == "jnp"


def test_segmented_execution_bitwise_equals_single_scan(scene):
    """VERDICT r1 #7 (compile latency): fixed-length segmented execution is a
    pure execution-boundary change — scan(8)∘scan(8)∘… performs the identical
    op sequence as scan(30), so fields AND the av_vels series are bitwise
    equal to the one-executable path."""
    ref = run_simulation(scene, RunConfig(variant="jnp", segment_steps=0))
    seg = run_simulation(scene, RunConfig(variant="jnp", segment_steps=8))
    np.testing.assert_array_equal(seg.f, ref.f)
    np.testing.assert_array_equal(seg.av_vels, ref.av_vels)
    assert len(seg.av_vels) == 30


def test_segmented_execution_sharded_and_chunked(scene):
    """Segmenting composes with the sharded disciplines; for multi-step
    (chunked) programs the segment length is rounded up to a whole number
    of chunks."""
    ref = run_simulation(
        scene, RunConfig(variant="sync", num_devices=8, backend="jnp",
                         segment_steps=0)
    )
    seg = run_simulation(
        scene, RunConfig(variant="sync", num_devices=8, backend="jnp",
                         segment_steps=7)
    )
    np.testing.assert_array_equal(seg.f, ref.f)
    np.testing.assert_array_equal(seg.av_vels, ref.av_vels)
    # chunked advances `staleness` steps per call: segment 7 with chunk 2
    # must round to 8 rather than raise.
    chunked = run_simulation(
        scene, RunConfig(variant="chunked", num_devices=8, backend="jnp",
                         staleness=2, segment_steps=7)
    )
    assert len(chunked.av_vels) == 30


def test_segment_lengths_policy(scene):
    from lbm_tpu.models.driver import _segment_lengths
    from lbm_tpu.parallel import modes

    prog = modes.build_single_program(
        scene.params, scene.obstacles, backend="jnp"
    )
    # Auto: short runs stay single-executable.
    assert _segment_lengths(30, RunConfig(), prog) is None
    # Explicit length: quotient segments plus remainder.
    assert _segment_lengths(30, RunConfig(segment_steps=8), prog) == [8, 8, 8, 6]
    assert _segment_lengths(16, RunConfig(segment_steps=8), prog) == [8, 8]
    # Frames/debug need whole-run buffers -> never segmented.
    assert (
        _segment_lengths(30, RunConfig(segment_steps=8, frame_interval=10), prog)
        is None
    )
    assert _segment_lengths(30, RunConfig(segment_steps=8, debug=True), prog) is None
