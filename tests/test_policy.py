"""Selection policy and environment contracts.

- auto picks the per-step backend by platform: the XLA step on a CPU, the
  block kernel on a GPU;
- a forced block kernel where it cannot compile (no GPU, no interpreter)
  raises instead of falling back;
- the compile cache lives in $JAX_COMPILATION_CACHE_DIR when set, else in
  <checkout>/.jax_cache;
- chip_smoke.py fails, printing no result line, where there is no GPU or
  no repository beside it.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax

from lbm_tpu.io.scene import Scene
from lbm_tpu.models.driver import RunConfig, _pick_variant, run_simulation
from lbm_tpu.parallel import modes
from lbm_tpu.params import LBMParams
from lbm_tpu.utils import compcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scene(ny=16, nx=24):
    params = LBMParams(nx=nx, ny=ny, max_iters=4, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    mask = np.zeros((ny, nx), dtype=bool)
    mask[0, :] = mask[-1, :] = True
    return Scene(params=params, obstacles=mask)


@pytest.mark.parametrize(
    "platform,expected", [("cpu", "jnp"), ("gpu", "pallas")]
)
@pytest.mark.parametrize("storage", ["f32", "i16"])
def test_auto_backend_by_platform(monkeypatch, platform, expected, storage):
    """The platform alone decides; the storage only names the variant."""
    assert modes.auto_backend(platform) == expected
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    cfg = RunConfig(num_devices=1, storage=storage)
    assert _pick_variant(_scene(), cfg) == expected


@pytest.mark.parametrize("platform,expected", [("cpu", "jnp"), ("gpu", "pallas")])
def test_single_device_auto_variant_follows_platform(
    monkeypatch, platform, expected
):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert _pick_variant(_scene(), RunConfig(num_devices=1)) == expected


@pytest.mark.parametrize("storage", ["f32", "i16"])
def test_forced_kernel_without_gpu_raises(storage):
    """--backend pallas on a host without a GPU: an error naming the
    cause, not a silent run of another step."""
    with pytest.raises(ValueError, match="compiles for a GPU"):
        run_simulation(
            _scene(),
            RunConfig(variant="pallas", storage=storage, num_steps=2),
        )


def test_forced_kernel_slab_needs_rows():
    from lbm_tpu.ops import fused_pallas

    with pytest.raises(ValueError, match="at least one output row"):
        fused_pallas.make_slab_step(_scene().params, 0, 24, 16, interpret=True)


def test_unknown_backend_raises():
    s = _scene()
    with pytest.raises(ValueError, match="unknown backend"):
        modes.build_single_program(s.params, s.obstacles, backend="mosaic")


def test_compile_cache_dir_from_environment(monkeypatch, tmp_path):
    monkeypatch.delenv("LBM_NO_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compcache.cache_dir() == str(tmp_path)
    # JAX reads the variable itself; nothing here sets another directory.
    before = jax.config.jax_compilation_cache_dir
    assert compcache.enable_persistent_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_dir_default_is_in_the_checkout(monkeypatch):
    monkeypatch.delenv("LBM_NO_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compcache.cache_dir() == os.path.join(REPO, ".jax_cache")
    monkeypatch.setenv("LBM_NO_COMPILE_CACHE", "1")
    assert compcache.cache_dir() is None
    assert compcache.enable_persistent_cache() is None


def _smoke(cwd, script):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    # chip_smoke.py holds JAX to CUDA itself; hide any card so that "no
    # GPU" holds on every host.
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _last_json(stdout):
    lines = stdout.strip().splitlines()
    if not lines:
        return None
    try:
        return json.loads(lines[-1])
    except ValueError:
        return None


def test_chip_smoke_fails_without_gpu():
    proc = _smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert proc.returncode != 0
    assert _last_json(proc.stdout) is None


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _smoke(tmp_path, str(tmp_path / "chip_smoke.py"))
    assert proc.returncode != 0
    assert _last_json(proc.stdout) is None
