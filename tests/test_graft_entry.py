"""Driver-contract tests for __graft_entry__ (entry + dryrun_multichip).

dryrun_multichip must re-run itself on a virtual CPU mesh, and say so,
when the host has fewer devices than requested, instead of asserting on
the device count.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import __graft_entry__ as graft  # noqa: E402


def test_entry_compiles_and_runs():
    fn, args = graft.entry()
    f_new, tot_u = jax.jit(fn)(*args)
    assert f_new.shape == args[0].shape
    assert np.isfinite(float(tot_u))


def test_dryrun_in_process_on_virtual_mesh():
    # conftest provides 8 CPU devices, so this takes the in-process path.
    assert len(jax.devices()) >= 8
    graft.dryrun_multichip(8)


def test_dryrun_bootstraps_subprocess_when_devices_missing():
    """Simulate the driver's bench box: a fresh process with ONE device
    calls dryrun_multichip(4) and must succeed by re-execing a virtual
    CPU mesh subprocess."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # no pre-forced device count
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu'); "
        "assert len(jax.devices()) == 1, jax.devices(); "
        "import __graft_entry__ as g; g.dryrun_multichip(4); "
        "print('BOOTSTRAP_OK')"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr
    assert "BOOTSTRAP_OK" in proc.stdout
    # The re-run on a virtual CPU mesh is announced, never silent.
    assert "re-running on a virtual 4-device CPU mesh" in proc.stdout
    # 12 relations, each with an explicit correctness check: sync/overlap
    # bitwise, ca K=2/K=4 bitwise vs sync, sync-i16 in the quant envelope
    # with overlap-i16 and ca-i16 bitwise vs it, async 1/3 + chunked
    # inside the model-derived envelope, and the exact ghost-age
    # reconstruction.
    assert proc.stdout.count("dryrun ok:") == 12
    assert proc.stdout.count("bitwise") >= 6
    assert "exact comm-avoiding" in proc.stdout
    assert "bounded staleness" in proc.stdout
    assert proc.stdout.count("ghost age exact") == 2
