"""int16 fixed-point deviation storage (ops/quant.py + --storage i16).

Accuracy evidence behind the mode (full 40000-step runs vs the reference
goldens): raw bf16 diverges 50%, bf16 deviations drift 3.7%, i16 deviations
hold 0.088-0.32% — see ops/quant.py's module docstring.  These tests pin the
codec mechanics and the driver plumbing on small CPU grids.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lbm_tpu.core import lattice
from lbm_tpu.io.scene import Scene
from lbm_tpu.models import RunConfig, run_simulation
from lbm_tpu.ops import quant
from lbm_tpu.params import LBMParams


@pytest.fixture
def scene(small_params, small_obstacles):
    return Scene(params=small_params.replace(max_iters=30), obstacles=small_obstacles)


def test_quantize_roundtrip_error_bounded():
    density = 0.1
    rng = np.random.default_rng(0)
    f = lattice.equilibrium_rest(density, 8, 128) * (
        1 + 0.15 * rng.standard_normal((9, 8, 128)).astype(np.float32)
    )
    q = quant.quantize(jnp.asarray(f), density)
    back = np.asarray(quant.dequantize(q, density))
    # Error per value is at most half a quantization step.
    step = quant.RANGE_C * np.asarray(lattice.WEIGHTS) * density / 32767.0
    assert (np.abs(back - f) <= step.reshape(9, 1, 1) * 0.50001).all()
    # Relative to f itself the step is ~RANGE_C/32767 ~ 6e-5.
    assert np.abs(back / f - 1).max() < 2e-4


def test_quantize_saturates_instead_of_wrapping():
    density = 0.1
    f = jnp.asarray(lattice.equilibrium_rest(density, 8, 128)) * 100.0
    q = quant.quantize(f, density)
    assert int(jnp.max(q)) == 32767 and int(jnp.min(q)) >= -32767


def test_requantize_is_identity():
    """Bounce-back mirrors stored values; dequantize->requantize must
    reproduce the identical int16 so obstacle cells never drift."""
    density = 0.1
    rng = np.random.default_rng(1)
    q0 = jnp.asarray(
        rng.integers(-32767, 32768, size=(9, 8, 128), dtype=np.int64),
        dtype=jnp.int16,
    )
    f = quant.dequantize(q0, density)
    q1 = quant.quantize(f, density)
    np.testing.assert_array_equal(np.asarray(q0), np.asarray(q1))



@pytest.mark.parametrize("jit", [False, True])
def test_round_half_even_matches_round(jit):
    """The codec's rounding (floor, compares, selects — the Triton route
    has no round primitive) equals jnp.round bitwise: random values, exact
    ties on both sides of zero, values one ulp below a tie, and the int16
    range edges — also under jit, where XLA may rewrite arithmetic."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-40000, 40000, 50000).astype(np.float32)
    ties = np.arange(-200, 200).astype(np.float32) + np.float32(0.5)
    below = np.nextafter(ties, np.float32(0))
    small = rng.uniform(-2, 2, 5000).astype(np.float32)
    edges = np.array([32767.0, -32767.0, 32766.5, -32766.5, 0.0, -0.0],
                     np.float32)
    x = jnp.asarray(np.concatenate([x, ties, below, small, edges]))
    fn = jax.jit(quant.round_half_even) if jit else quant.round_half_even
    np.testing.assert_array_equal(np.asarray(fn(x)), np.asarray(jnp.round(x)))


@pytest.mark.parametrize("jit", [False, True])
def test_quantize_matches_round_half_even(jit):
    """quantize_plane equals NumPy's round-half-to-even of the scaled
    deviation, clipped to +-32767, on random deviations, exact half-step
    ties, and saturating values — eagerly and under jit."""
    density = 0.1
    rng = np.random.default_rng(3)
    for k in range(9):
        s = quant.plane_scales(density)[k]
        rest = quant.plane_rest(density)[k]
        x = (rest * (1 + 0.3 * rng.standard_normal(20000))).astype(np.float32)
        ties = ((np.arange(-64, 64) + 0.5) / s + rest).astype(np.float32)
        big = np.array([rest * 50, -rest * 50], np.float32)
        x = np.concatenate([x, ties, big])
        qp = lambda v, k=k: quant.quantize_plane(v, k, density)
        fn = jax.jit(qp) if jit else qp
        got = np.asarray(fn(jnp.asarray(x)))
        want = np.clip(
            np.round((x - np.float32(rest)) * np.float32(s)), -32767, 32767
        ).astype(np.int16)
        np.testing.assert_array_equal(got, want)


def _box_scene(ny: int, nx: int, max_iters: int) -> Scene:
    params = LBMParams(
        nx=nx, ny=ny, max_iters=max_iters, reynolds_dim=10,
        density=0.1, accel=0.005, omega=1.85,
    )
    mask = np.zeros((ny, nx), dtype=bool)
    mask[0, :] = mask[-1, :] = True
    mask[:, 0] = mask[:, -1] = True
    return Scene(params=params, obstacles=mask)


def _oracle_i16(params, mask, steps):
    """Independent reference of the i16 semantics: the NumPy oracle step
    between a NumPy quantize/dequantize of every plane after every step."""
    from lbm_tpu.core import oracle

    s = quant.plane_scales(params.density)[:, None, None]
    rest = quant.plane_rest(params.density)[:, None, None]
    f = lattice.equilibrium_rest(params.density, params.ny, params.nx)
    for _ in range(steps):
        f = oracle.timestep(f, mask, params)
        q = np.clip(np.round((f - rest) * s), -32767, 32767)
        f = (q.astype(np.float32) * (np.float32(1.0) / s) + rest).astype(
            np.float32
        )
    return f


def test_driver_i16_matches_f32_closely():
    """30 steps: the quantized run (the XLA step inside the int16 codec,
    auto on a CPU) follows the i16 semantics — an independent NumPy
    reference quantizing after every step — to a few quantization steps,
    and tracks the exact run far inside the 1% output contract."""
    sc = _box_scene(16, 128, 30)
    ref = run_simulation(sc, RunConfig(variant="jnp"))
    res = run_simulation(sc, RunConfig(storage="i16", num_devices=1))
    assert res.variant == "jnp-i16"
    assert res.f.dtype == np.float32  # f_of dequantizes
    f_i16 = _oracle_i16(sc.params, sc.obstacles, 30)
    rel_f = np.abs(res.f - f_i16).max() / np.abs(f_i16).max()
    assert rel_f < 5e-4
    assert np.abs(res.f - ref.f).max() < 1e-4
    # Early-transient av velocities are ~1e-4, so per-step quantization
    # noise is relatively amplified; the output contract bound is 1%.
    np.testing.assert_allclose(res.av_vels, ref.av_vels, rtol=1e-2)


def test_driver_i16_any_width():
    """A width that is a multiple of nothing runs i16 unpadded."""
    sc = _box_scene(16, 100, 20)
    ref = run_simulation(sc, RunConfig(variant="jnp"))
    res = run_simulation(sc, RunConfig(variant="jnp", storage="i16"))
    assert res.variant == "jnp-i16"
    assert res.f.shape == ref.f.shape
    assert np.abs(res.f - ref.f).max() / np.abs(ref.f).max() < 5e-4


def test_i16_rejects_unsupported_variants(scene):
    with pytest.raises(ValueError, match="serial"):
        run_simulation(scene, RunConfig(variant="serial", storage="i16"))
    with pytest.raises(ValueError, match="unknown storage"):
        run_simulation(scene, RunConfig(variant="jnp", storage="f16"))
    with pytest.raises(ValueError, match="unknown storage"):
        run_simulation(
            scene, RunConfig(variant="sync", num_devices=8, storage="bf16")
        )


def test_sharded_i16_matches_single_device_i16():
    """sync sharding is a pure decomposition: the i16 state evolution over
    8 shards matches the single-device i16 run bitwise (the same XLA step
    on the same dequantized values, quantized after every step)."""
    sc = _box_scene(16, 128, 20)
    single = run_simulation(sc, RunConfig(variant="jnp", storage="i16"))
    for variant in ("sync", "overlap"):
        res = run_simulation(
            sc, RunConfig(variant=variant, num_devices=8, storage="i16")
        )
        assert res.variant == f"{variant}-i16"
        np.testing.assert_array_equal(res.f, single.f)
        np.testing.assert_allclose(res.av_vels, single.av_vels, rtol=1e-5)


@pytest.mark.parametrize(
    "variant,staleness",
    [("sync", None), ("overlap", None), ("ca", 2), ("ca", 4),
     ("async", 1), ("async-k", 2), ("chunked", 2)],
)
def test_i16_sharded_modes_in_quant_envelope(variant, staleness):
    """Every sharded discipline with int16 state stays within the
    quantization envelope of the same discipline's f32 run (stale modes
    deviate from sync by their own halo age, identically in both
    storages)."""
    sc = _box_scene(32, 64, 12)
    cfg = dict(variant=variant, num_devices=4, staleness=staleness)
    f32 = run_simulation(sc, RunConfig(**cfg))
    i16 = run_simulation(sc, RunConfig(**cfg, storage="i16"))
    assert i16.variant.endswith("-i16")
    assert np.abs(i16.f - f32.f).max() < 1e-4
    # av of the early transient is ~1e-4, so quantization noise (~1e-5
    # absolute on this 32x64 box) is bounded absolutely.
    np.testing.assert_allclose(i16.av_vels, f32.av_vels, rtol=1e-2, atol=2e-5)


def test_sharded_i16_async_and_chunked_run():
    sc = _box_scene(16, 128, 20)
    ref = run_simulation(sc, RunConfig(variant="sync", num_devices=2, storage="i16"))
    for variant, staleness in (("async", 1), ("chunked", 2)):
        res = run_simulation(
            sc,
            RunConfig(
                variant=variant, num_devices=2, staleness=staleness, storage="i16"
            ),
        )
        assert res.variant.endswith("-i16")
        rel = np.abs(res.f - ref.f).max() / np.abs(ref.f).max()
        assert rel < 1e-2  # stale halos deviate but stay inside the contract


def test_i16_frames_and_u_mag():
    """Frame capture dequantizes per snapshot: each frame is |u| of the
    dequantized i16 state at its step (frame k follows k*interval+1
    steps), and the run's state stays in the quantization envelope of the
    f32 run."""
    from lbm_tpu.io.writers import macroscopics

    sc = _box_scene(16, 128, 20)
    ref = run_simulation(sc, RunConfig(variant="jnp", frame_interval=10))
    res = run_simulation(
        sc, RunConfig(variant="jnp", storage="i16", frame_interval=10)
    )
    assert res.frames is not None and res.frames.shape == ref.frames.shape
    for k, steps in enumerate((1, 11)):
        st = run_simulation(
            sc, RunConfig(variant="jnp", storage="i16", num_steps=steps)
        )
        _, _, u, _ = macroscopics(st.f, sc.obstacles, sc.params)
        np.testing.assert_allclose(res.frames[k], u, rtol=1e-5, atol=1e-9)
    assert np.abs(res.f - ref.f).max() < 1e-4


@pytest.mark.parametrize("variant,devices", [("jnp", None), ("sync", 4)])
def test_i16_checkpoint_resume_bitwise(tmp_path, variant, devices):
    """Resume requantizes the dequantized checkpoint; the requant identity
    makes the resumed i16 run reproduce the uninterrupted one bitwise."""
    sc = _box_scene(16, 128, 20)
    cfg = dict(variant=variant, num_devices=devices, storage="i16")
    full = run_simulation(sc, RunConfig(**cfg))
    run_simulation(
        sc,
        RunConfig(**cfg, checkpoint_every=10, checkpoint_dir=str(tmp_path)),
    )
    resumed = run_simulation(
        sc,
        RunConfig(**cfg, resume_from=str(tmp_path / "ckpt_00000010.npz")),
    )
    np.testing.assert_array_equal(resumed.f, full.f)
    np.testing.assert_array_equal(resumed.av_vels[10:], full.av_vels[10:])
