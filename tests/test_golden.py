"""Golden-data integration tests against the reference's check/ fixtures.

The reference's only test modality is end-to-end golden comparison at 1%
tolerance (check/check.py:136-151).  Fast prefix checks run always (the
av_vels series is per-step, so the first N steps are comparable); full-run
checks are marked slow.
"""

import numpy as np
import pytest

from lbm_tpu.io import load_scene
from lbm_tpu.models import RunConfig, run_simulation
from lbm_tpu.tools.check import compare_series
from tests.conftest import requires_reference

REF = "/root/reference"
PREFIX_STEPS = 120


def _scene(grid):
    return load_scene(
        f"{REF}/dataSet/input_{grid}.params", f"{REF}/dataSet/obstacles_{grid}.dat"
    )


def _golden_av(grid, n=None):
    gold = np.loadtxt(f"{REF}/check/{grid}.av_vels.dat", usecols=[1])
    return gold[:n] if n else gold


@requires_reference
@pytest.mark.parametrize("variant", ["jnp", "serial"])
def test_single_device_prefix_parity(variant):
    scene = _scene("128x128")
    res = run_simulation(
        scene, RunConfig(variant=variant, num_steps=PREFIX_STEPS)
    )
    gold = _golden_av("128x128", PREFIX_STEPS)
    diff = compare_series(gold, res.av_vels)
    assert abs(diff.max_diff_pcnt) < 0.1, diff


@requires_reference
def test_sharded_async_prefix_parity():
    """The stale-halo mode must stay inside the reference's 1% accuracy
    contract (README.md:9-13) at a realistic shard-to-grid ratio (2 shards
    over 128 rows = 3.1% stale rows; measured full-curve max 0.53%)."""
    scene = _scene("128x128")
    res = run_simulation(
        scene,
        RunConfig(variant="async", num_devices=2, num_steps=PREFIX_STEPS),
    )
    gold = _golden_av("128x128", PREFIX_STEPS)
    diff = compare_series(gold, res.av_vels)
    assert abs(diff.max_diff_pcnt) < 1.0, diff


@requires_reference
def test_async_overshard_warns():
    """Over-sharded async configs (many stale rows) warn about accuracy."""
    scene = _scene("128x128")
    with pytest.warns(UserWarning, match="stale"):
        run_simulation(
            scene, RunConfig(variant="async", num_devices=8, num_steps=4)
        )


@pytest.mark.parametrize("storage", ["f32", "i16"])
def test_committed_1024_scene_matches_golden_prefix(storage):
    """The committed 1024^2 scene (golden/input_1024x1024.params and
    obstacles_1024x1024.dat, recovered from the golden final state: the
    obstacle column, density from the obstacle pressure, accel and omega
    from the av_vels prefix) reproduces the first 50 golden av_vels.

    rtol 5e-5, not tighter: the golden series sums |u| over a million
    cells in float32 on another backend (golden/README.md), and a
    different summation order alone moves it by ~2e-5 relative (the NumPy
    oracle sits 1.9e-5 from it at step 2); the nearest alternative
    parameters (accel 0.005, or omega 1.7) miss by 50% and 20%.  i16
    storage stays inside its quantization envelope."""
    import pathlib

    from lbm_tpu.io.writers import read_av_vels

    root = pathlib.Path(__file__).resolve().parents[1] / "golden"
    scene = load_scene(
        root / "input_1024x1024.params", root / "obstacles_1024x1024.dat"
    )
    p = scene.params
    assert (p.nx, p.ny, p.max_iters) == (1024, 1024, 20000)
    assert (p.density, p.accel, p.omega) == (0.1, 0.01, 1.85)
    assert int(scene.obstacles.sum()) == 5114
    assert scene.obstacles[:, 341].all()
    steps = 50
    res = run_simulation(
        scene, RunConfig(variant="jnp", num_steps=steps, storage=storage)
    )
    gold = read_av_vels(root / "1024x1024.av_vels.dat.gz")[:steps]
    rtol = 5e-5 if storage == "f32" else 1e-2
    np.testing.assert_allclose(res.av_vels, gold, rtol=rtol)


@requires_reference
@pytest.mark.slow
@pytest.mark.parametrize("grid", ["128x128", "128x256", "256x256"])
def test_full_run_av_vels_parity(grid):
    """Full-length golden comparison (slow; run with -m slow or on a GPU)."""
    scene = _scene(grid)
    res = run_simulation(scene, RunConfig(variant="auto", num_devices=1))
    diff = compare_series(_golden_av(grid), res.av_vels)
    assert abs(diff.max_diff_pcnt) < 1.0, diff


def test_regenerated_golden_loads():
    """The committed 256x256 and 1024x1024 regression goldens load through
    the standard readers (gzip transparently handled)."""
    import pathlib

    from lbm_tpu.io.writers import read_av_vels, read_final_state

    root = pathlib.Path(__file__).resolve().parents[1] / "golden"
    av = read_av_vels(root / "256x256.av_vels.dat.gz")
    assert av.shape == (80000,)
    fs = read_final_state(root / "256x256.final_state.dat.gz")
    assert fs.shape == (256 * 256, 3)
    av = read_av_vels(root / "1024x1024.av_vels.dat.gz")
    assert av.shape == (20000,)
    # The 1024^2 final_state is ~1M lines; parse a prefix to keep this fast.
    import gzip

    with gzip.open(root / "1024x1024.final_state.dat.gz", "rt") as fh:
        first = fh.readline().split()
    assert len(first) == 7 and first[0] == "0" and first[1] == "0"


@requires_reference
def test_regenerated_1024_golden_matches_reference_av_vels():
    """The committed 1024^2 regression golden agrees with the reference's
    surviving av_vels golden to 0.04% (the final_state golden was produced
    by the same validated run)."""
    import pathlib

    from lbm_tpu.io.writers import read_av_vels

    root = pathlib.Path(__file__).resolve().parents[1] / "golden"
    mine = read_av_vels(root / "1024x1024.av_vels.dat.gz")
    gold = _golden_av("1024x1024")
    diff = compare_series(gold, mine)
    assert abs(diff.max_diff_pcnt) < 0.1, diff


@requires_reference
@pytest.mark.slow
def test_1024_prefix_matches_numpy_oracle():
    """Anchor the 1024^2 golden's provenance OUTSIDE the JAX stack
    (VERDICT r2 #8): the jnp path's first 120 steps match the pure-NumPy
    serial oracle (C expression order) at the flagship grid, and both match
    the reference's surviving av_vels golden prefix.  ~4 min (oracle is
    ~2 s/step at 1M cells), hence slow-marked."""
    from lbm_tpu.core import oracle

    steps = 120
    scene = _scene("1024x1024")
    f_o, av_o = oracle.run(scene.params, scene.obstacles, num_steps=steps)
    res = run_simulation(scene, RunConfig(variant="jnp", num_steps=steps))
    np.testing.assert_allclose(res.f, f_o, atol=2e-7)
    np.testing.assert_allclose(res.av_vels, av_o, rtol=1e-4)
    diff = compare_series(_golden_av("1024x1024", steps), av_o)
    assert abs(diff.max_diff_pcnt) < 0.1, diff


@requires_reference
@pytest.mark.slow
def test_full_256_run_matches_regenerated_final_state():
    """Full 256x256 run vs the committed final_state regression golden."""
    import pathlib

    from lbm_tpu.io.writers import read_final_state
    from lbm_tpu.io import write_final_state

    scene = _scene("256x256")
    res = run_simulation(scene, RunConfig(variant="auto", num_devices=1))
    import tempfile, os

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "fs.dat")
        write_final_state(path, res.f, scene.obstacles, scene.params)
        fs = read_final_state(path)
    root = pathlib.Path(__file__).resolve().parents[1] / "golden"
    gold = read_final_state(root / "256x256.final_state.dat.gz")
    diff = compare_series(gold[:, 2], fs[:, 2])
    assert abs(diff.max_diff_pcnt) < 1.0, diff
