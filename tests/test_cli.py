"""CLI surface tests (in-process main())."""

import numpy as np
import pytest

from lbm_tpu.cli import main
from lbm_tpu.io.writers import read_av_vels
from tests.conftest import requires_reference


@pytest.fixture
def scene_files(tmp_path, small_params, small_obstacles):
    p = tmp_path / "input.params"
    p.write_text(
        f"{small_params.nx}\n{small_params.ny}\n20\n{small_params.reynolds_dim}\n"
        f"{small_params.density}\n{small_params.accel}\n{small_params.omega}\n"
    )
    o = tmp_path / "obstacles.dat"
    ys, xs = np.nonzero(small_obstacles)
    o.write_text("".join(f"{x} {y} 1\n" for x, y in zip(xs, ys)))
    return str(p), str(o)


def test_run_and_check_roundtrip(tmp_path, scene_files, capsys):
    paramfile, obstaclefile = scene_files
    out = tmp_path / "out"
    rc = main([
        "run", paramfile, obstaclefile, "--variant", "jnp", "--out-dir", str(out),
    ])
    assert rc == 0
    captured = capsys.readouterr().out
    assert "==done==" in captured
    assert "Reynolds number:" in captured
    assert "Elapsed Compute time:" in captured
    av = read_av_vels(out / "av_vels.dat")
    assert len(av) == 20

    # Self-check: outputs compared against themselves must pass.
    rc = main([
        "check",
        "--ref-av-vels-file", str(out / "av_vels.dat"),
        "--ref-final-state-file", str(out / "final_state.dat"),
        "--av-vels-file", str(out / "av_vels.dat"),
        "--final-state-file", str(out / "final_state.dat"),
    ])
    assert rc == 0


def test_check_detects_divergence(tmp_path, scene_files, capsys):
    paramfile, obstaclefile = scene_files
    a, b = tmp_path / "a", tmp_path / "b"
    main(["run", paramfile, obstaclefile, "--variant", "jnp", "--out-dir", str(a)])
    main(["run", paramfile, obstaclefile, "--variant", "jnp", "--out-dir", str(b),
          "--steps", "19"])
    rc = main([
        "check",
        "--ref-av-vels-file", str(a / "av_vels.dat"),
        "--ref-final-state-file", str(a / "final_state.dat"),
        "--av-vels-file", str(b / "av_vels.dat"),
        "--final-state-file", str(b / "final_state.dat"),
    ])
    assert rc == 1  # different number of steps
    assert "Different number of steps" in capsys.readouterr().out


def test_run_bad_obstacles_exit_code(tmp_path, scene_files, capsys):
    paramfile, _ = scene_files
    bad = tmp_path / "bad.dat"
    bad.write_text("0 99 1\n")
    rc = main(["run", paramfile, str(bad)])
    assert rc == 1
    assert "out of range" in capsys.readouterr().err


def test_info(capsys):
    assert main(["info"]) == 0
    assert "backend=" in capsys.readouterr().out


@requires_reference
def test_golden_prefix_through_cli(tmp_path, capsys):
    """300-step prefix through the full CLI matches the golden series."""
    out = tmp_path / "out"
    rc = main([
        "run",
        "/root/reference/dataSet/input_128x128.params",
        "/root/reference/dataSet/obstacles_128x128.dat",
        "--variant", "jnp", "--steps", "300", "--out-dir", str(out),
    ])
    assert rc == 0
    av = read_av_vels(out / "av_vels.dat")
    gold = np.loadtxt("/root/reference/check/128x128.av_vels.dat", usecols=[1])[:300]
    rel = 100 * np.abs((gold - av) / av)
    assert rel.max() < 0.1


def test_run_plan_flag(tmp_path, capsys):
    """--plan prints the execution plan (derived from the real selection
    functions) and exits without running."""
    from lbm_tpu.cli import main
    from lbm_tpu.tools.scenegen import main as scene_main

    scene_main(
        ["--grid", "256x32", "--preset", "cavity",
         "--out-dir", str(tmp_path), "--name", "p"]
    )
    rc = main(
        ["run", str(tmp_path / "input_p.params"),
         str(tmp_path / "obstacles_p.dat"), "--plan", "--variant", "pallas"]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert "variant: pallas" in out
    assert "path: Triton block kernel" in out

    rc = main(
        ["run", str(tmp_path / "input_p.params"),
         str(tmp_path / "obstacles_p.dat"), "--plan",
         "--variant", "ca", "--devices", "4", "--staleness", "2"]
    )
    out = capsys.readouterr().out
    assert rc == 0
    assert "communication-avoiding: 2-deep exchange" in out
