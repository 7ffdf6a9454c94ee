"""Checkpoint/resume: interrupted runs continue to identical results."""

import numpy as np
import pytest

from lbm_tpu.io.scene import Scene
from lbm_tpu.models import RunConfig, run_simulation


@pytest.fixture
def scene(small_params, small_obstacles):
    return Scene(params=small_params.replace(max_iters=20), obstacles=small_obstacles)


def test_checkpoint_and_resume_bitwise(tmp_path, scene):
    ref = run_simulation(scene, RunConfig(variant="jnp"))

    ckdir = tmp_path / "ck"
    res = run_simulation(
        scene,
        RunConfig(variant="jnp", checkpoint_every=7, checkpoint_dir=str(ckdir)),
    )
    # Segmented execution is the same scan math: bitwise-equal final state.
    np.testing.assert_array_equal(res.f, ref.f)
    np.testing.assert_allclose(res.av_vels, ref.av_vels, rtol=1e-6)
    cks = sorted(ckdir.glob("ckpt_*.npz"))
    assert [int(p.stem.split("_")[1]) for p in cks] == [7, 14, 20]

    # Resume from the middle checkpoint; the completed series and final state
    # match the uninterrupted run.
    res2 = run_simulation(
        scene, RunConfig(variant="jnp", resume_from=str(cks[1]))
    )
    np.testing.assert_array_equal(res2.f, ref.f)
    assert len(res2.av_vels) == 20
    np.testing.assert_allclose(res2.av_vels, ref.av_vels, rtol=1e-6)


def test_resume_sharded(tmp_path, scene):
    ckdir = tmp_path / "ck"
    run_simulation(
        scene,
        RunConfig(variant="sync", num_devices=2, checkpoint_every=10,
                  checkpoint_dir=str(ckdir)),
    )
    ck = sorted(ckdir.glob("ckpt_*.npz"))[0]
    res = run_simulation(
        scene, RunConfig(variant="sync", num_devices=2, resume_from=str(ck))
    )
    ref = run_simulation(scene, RunConfig(variant="jnp"))
    np.testing.assert_array_equal(res.f, ref.f)


def test_resume_rejects_mismatched_grid(tmp_path, scene, small_params):
    ckdir = tmp_path / "ck"
    run_simulation(
        scene, RunConfig(variant="jnp", checkpoint_every=20, checkpoint_dir=str(ckdir))
    )
    ck = next(iter(ckdir.glob("ckpt_*.npz")))
    bad = Scene(
        params=small_params.replace(nx=32, max_iters=20),
        obstacles=np.zeros((16, 32), dtype=bool),
    )
    with pytest.raises(ValueError, match="does not match"):
        run_simulation(bad, RunConfig(variant="jnp", resume_from=str(ck)))


def test_checkpoint_and_resume_ca(tmp_path):
    """Multi-step (K-per-call) programs checkpoint at chunk boundaries and
    resume to the same result as an uninterrupted ca run."""
    from lbm_tpu.params import LBMParams

    params = LBMParams(
        nx=128, ny=32, max_iters=16, reynolds_dim=10,
        density=0.1, accel=0.005, omega=1.85,
    )
    mask = np.zeros((32, 128), dtype=bool)
    mask[0, :] = mask[-1, :] = True
    sc = Scene(params=params, obstacles=mask)
    cfg = dict(variant="ca", num_devices=4, staleness=4)
    ref = run_simulation(sc, RunConfig(**cfg))

    ckdir = tmp_path / "ck"
    res = run_simulation(
        sc,
        RunConfig(**cfg, checkpoint_every=8, checkpoint_dir=str(ckdir)),
    )
    np.testing.assert_array_equal(res.f, ref.f)
    cks = sorted(ckdir.glob("ckpt_*.npz"))
    assert [int(p.stem.split("_")[1]) for p in cks] == [8, 16]
    res2 = run_simulation(sc, RunConfig(**cfg, resume_from=str(cks[0])))
    np.testing.assert_array_equal(res2.f, ref.f)
    np.testing.assert_allclose(res2.av_vels, ref.av_vels, rtol=1e-6)

    # checkpoint_every not a multiple of K is rejected with a clear error.
    with pytest.raises(ValueError, match="multiple of the chunk size"):
        run_simulation(
            sc, RunConfig(**cfg, checkpoint_every=6, checkpoint_dir=str(ckdir))
        )


def test_checkpoint_and_resume_i16(tmp_path):
    """i16 runs checkpoint the dequantized f32 state; resume re-quantizes.
    quantize(dequantize(q)) is the identity for in-range values (the codec
    rounds to the nearest step), so the resumed run matches the
    uninterrupted one exactly."""
    from lbm_tpu.params import LBMParams

    params = LBMParams(
        nx=128, ny=16, max_iters=16, reynolds_dim=10,
        density=0.1, accel=0.005, omega=1.85,
    )
    mask = np.zeros((16, 128), dtype=bool)
    mask[0, :] = mask[-1, :] = True
    sc = Scene(params=params, obstacles=mask)
    cfg = dict(variant="jnp", storage="i16")
    ref = run_simulation(sc, RunConfig(**cfg))

    ckdir = tmp_path / "ck"
    run_simulation(
        sc, RunConfig(**cfg, checkpoint_every=8, checkpoint_dir=str(ckdir))
    )
    cks = sorted(ckdir.glob("ckpt_*.npz"))
    res = run_simulation(sc, RunConfig(**cfg, resume_from=str(cks[0])))
    np.testing.assert_array_equal(res.f, ref.f)
    np.testing.assert_allclose(res.av_vels, ref.av_vels, rtol=1e-6)
