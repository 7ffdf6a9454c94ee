"""Benchmark runner: MLUPS per grid/variant, with baseline comparison.

The reference's published metric is compute-phase runtime per scene
(README.md:124-129); BASELINE.md derives MLUPS = nx*ny*iters/time.  This
module times the on-device scan loop (compile excluded, like the reference's
Compute bracket, SerialCode/d2q9-bgk.c:161-184; the driver ends the bracket
with ``jax.block_until_ready``) and reports MLUPS plus the ratio to the
reference's best (fully-async, 80-core) number for that grid, beside the
device it ran on.
"""

from __future__ import annotations

import os
import time

import numpy as np

# Reference best (fully-async MPI_Testall, 80 cores) MLUPS per grid, derived
# from README.md:124-129 (see BASELINE.md).
REFERENCE_BEST_MLUPS = {
    "128x128": 1587.0,
    "128x256": 922.0,
    "256x256": 1530.0,
    "1024x1024": 1796.0,
}

# Reference scenes committed with their goldens (golden/README.md).
GOLDEN_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "golden",
)


def scene_files(grid: str) -> tuple[str, str] | None:
    """(params, obstacles) paths of the committed reference scene for
    ``grid``, or None."""
    pfile = os.path.join(GOLDEN_DIR, f"input_{grid}.params")
    ofile = os.path.join(GOLDEN_DIR, f"obstacles_{grid}.dat")
    if os.path.exists(pfile) and os.path.exists(ofile):
        return pfile, ofile
    return None


def load_or_make_scene(grid: str):
    """Load the committed reference scene for `grid`, or synthesize a
    closed-box scene (the reference geometry: full border blocked)."""
    from lbm_tpu.io import load_scene
    from lbm_tpu.io.scene import Scene
    from lbm_tpu.params import LBMParams

    files = scene_files(grid)
    if files is not None:
        return load_scene(*files)

    nx, ny = (int(v) for v in grid.split("x"))
    iters = {"128x128": 40000, "128x256": 40000, "256x256": 80000}.get(grid, 20000)
    accel = 0.01 if max(nx, ny) >= 1024 else 0.005
    params = LBMParams(
        nx=nx, ny=ny, max_iters=iters, reynolds_dim=10,
        density=0.1, accel=accel, omega=1.85,
    )
    mask = np.zeros((ny, nx), dtype=bool)
    mask[0, :] = mask[-1, :] = True
    mask[:, 0] = mask[:, -1] = True
    return Scene(params=params, obstacles=mask)


def run_bench(
    grid: str = "1024x1024",
    variant: str = "auto",
    steps: int | None = None,
    devices: int | None = None,
    repeats: int = 3,
    storage: str = "f32",
    staleness: int | None = None,
) -> dict:
    from lbm_tpu.models.driver import RunConfig, run_simulation
    from lbm_tpu.utils.compcache import enable_persistent_cache

    enable_persistent_cache()
    scene = load_or_make_scene(grid)
    num_steps = steps if steps is not None else scene.params.max_iters
    config = RunConfig(
        variant=variant, num_devices=devices, num_steps=num_steps,
        storage=storage, staleness=staleness,
    )

    best_mlups = 0.0
    best = None
    for _ in range(max(1, repeats)):
        result = run_simulation(scene, config)
        if result.mlups > best_mlups:
            best_mlups, best = result.mlups, result
    assert best is not None

    import jax

    baseline = REFERENCE_BEST_MLUPS.get(grid)
    dev = jax.devices()[0]
    return {
        "metric": f"MLUPS {grid} {best.variant}",
        "storage": storage,
        "value": round(best_mlups, 1),
        "unit": "MLUPS",
        "vs_baseline": round(best_mlups / baseline, 3) if baseline else None,
        "grid": grid,
        "steps": num_steps,
        "variant": best.variant,
        "compute_s": round(best.timer.elapsed.get("compute", 0.0), 4),
        "reynolds": best.reynolds,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }


def compile_scan(program, steps: int):
    """The driver's ``steps``-step scan over ``program`` (no frames),
    compiled for its initial state; called as ``exe(program.init_state)``
    it returns ``(state, tot_u series, frames)``."""
    from lbm_tpu.models import driver

    return driver._make_scan(program, steps, None).lower(
        program.init_state).compile()


def time_scan(program, steps: int, repeats: int = 5) -> list[float]:
    """Wall seconds of ``repeats`` executions of the driver's compiled
    ``steps``-step scan over ``program`` (compiled and warmed first; each
    timing ends with ``jax.block_until_ready``)."""
    import jax

    state = program.init_state
    exe = compile_scan(program, steps)
    jax.block_until_ready(exe(state))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(exe(state))
        times.append(time.perf_counter() - t0)
    return times
