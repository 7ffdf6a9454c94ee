"""Tools: bench report, speedup plot, visualization, animation roundtrip."""

import json

import numpy as np
import pytest

from lbm_tpu.cli import main
from lbm_tpu.tools import animation, bench, speedup, visualize


def test_bench_report_schema(tmp_path, monkeypatch):
    report = bench.run_bench(grid="128x128", variant="jnp", steps=5, repeats=1)
    assert set(report) >= {"metric", "value", "unit", "vs_baseline"}
    assert report["unit"] == "MLUPS"
    assert report["value"] > 0
    # vs_baseline is rounded to 3 decimals and value to 1, so the two
    # roundings can disagree by up to one ulp of each.
    assert report["vs_baseline"] == pytest.approx(report["value"] / 1587.0, abs=1e-3)
    assert report["device"] == {"platform": "cpu", "kind": "cpu", "count": 8}


def test_bench_loads_the_committed_1024_scene():
    """bench's 1024^2 cell is the committed reference scene (full-height
    wall at x=341), not a synthesized closed box."""
    scene = bench.load_or_make_scene("1024x1024")
    assert (scene.params.accel, scene.params.omega) == (0.01, 1.85)
    assert scene.obstacles[:, 341].all()


def test_time_scan_times_each_repeat():
    from lbm_tpu.parallel import modes

    scene = bench.load_or_make_scene("32x32")
    prog = modes.build_single_program(scene.params, scene.obstacles)
    times = bench.time_scan(prog, 4, repeats=3)
    assert len(times) == 3 and all(t > 0 for t in times)


def test_bench_synthesized_scene():
    scene = bench.load_or_make_scene("64x64")
    assert scene.params.nx == 64 and scene.params.ny == 64
    # Closed box geometry like the reference scenes.
    assert scene.obstacles[0].all() and scene.obstacles[:, 0].all()


def test_speedup_plot(tmp_path):
    reports = [
        {"grid": "128x128", "value": 12000.0},
        {"grid": "1024x1024", "value": 5465.0},
    ]
    rp = tmp_path / "r.jsonl"
    rp.write_text("".join(json.dumps(r) + "\n" for r in reports))
    out = tmp_path / "s.png"
    assert speedup.main([str(rp), "--output", str(out)]) == 0
    assert out.stat().st_size > 1000


def test_frame_roundtrip(tmp_path, small_params):
    frames = np.random.default_rng(0).random((2, small_params.ny, small_params.nx)).astype(np.float32)
    paths = animation.write_frame_files(
        str(tmp_path), frames, np.array([0, 100]), small_params
    )
    assert len(paths) == 2
    grid, meta = animation.read_frame_file(paths[1])
    assert meta["timestep"] == 100
    np.testing.assert_allclose(grid, frames[1], rtol=1e-5)


def test_animate_and_viz(tmp_path, small_params, small_obstacles):
    # frames -> gif
    frames = np.random.default_rng(1).random((3, 16, 16)).astype(np.float32)
    animation.write_frame_files(str(tmp_path / "ad"), frames, np.arange(3) * 10, small_params)
    gif = animation.animate_directory(str(tmp_path / "ad"), str(tmp_path / "a.gif"), fps=5)
    assert (tmp_path / "a.gif").stat().st_size > 100

    # subsampled preview variant (Visualization/animation.py:146-198)
    animation.animate_directory(
        str(tmp_path / "ad"), str(tmp_path / "p.gif"), fps=3, every=2
    )
    assert (tmp_path / "p.gif").stat().st_size > 100

    # final_state -> 4-panel png through the CLI
    from lbm_tpu.core import lattice
    from lbm_tpu.io import writers

    f = lattice.equilibrium_rest(small_params.density, small_params.ny, small_params.nx)
    fs = tmp_path / "final_state.dat"
    writers.write_final_state(fs, f, small_obstacles, small_params)
    assert main(["viz", str(fs), "--output", str(tmp_path / "fs.png")]) == 0
    assert (tmp_path / "fs.png").stat().st_size > 1000


def test_golden_subcommand(tmp_path, small_params, small_obstacles):
    p = tmp_path / "input.params"
    p.write_text("16\n16\n8\n10\n0.1\n0.005\n1.85\n")
    o = tmp_path / "obstacles.dat"
    ys, xs = np.nonzero(small_obstacles)
    o.write_text("".join(f"{x} {y} 1\n" for x, y in zip(xs, ys)))
    rc = main(["golden", str(p), str(o), "--out-dir", str(tmp_path / "g")])
    assert rc == 0
    assert (tmp_path / "g" / "16x16.av_vels.dat").exists()
    assert (tmp_path / "g" / "16x16.final_state.dat").exists()


def test_debug_flag(tmp_path, small_params, small_obstacles, capsys):
    p = tmp_path / "input.params"
    p.write_text("16\n16\n3\n10\n0.1\n0.005\n1.85\n")
    o = tmp_path / "obstacles.dat"
    ys, xs = np.nonzero(small_obstacles)
    o.write_text("".join(f"{x} {y} 1\n" for x, y in zip(xs, ys)))
    rc = main(["run", str(p), str(o), "--variant", "jnp", "--debug",
               "--out-dir", str(tmp_path), "--no-output"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "==timestep: 0==" in out
    assert "av velocity:" in out and "tot density:" in out
    # Density invariant: all three reported densities equal the initial mass.
    dens = [float(l.split(":")[1]) for l in out.splitlines() if l.startswith("tot density")]
    expected = 0.1 * 16 * 16
    np.testing.assert_allclose(dens, expected, rtol=1e-5)


def test_scene_generator_roundtrip(tmp_path):
    """Generated scenes load through the standard scene loaders and run."""
    from lbm_tpu.io import load_scene
    from lbm_tpu.models import RunConfig, run_simulation
    from lbm_tpu.tools.scenegen import make_mask

    rc = main(["scene", "--grid", "32x16", "--preset", "cylinder",
               "--iters", "5", "--out-dir", str(tmp_path)])
    assert rc == 0
    sc = load_scene(tmp_path / "input_32x16_cylinder.params",
                    tmp_path / "obstacles_32x16_cylinder.dat")
    assert (sc.params.nx, sc.params.ny) == (32, 16)
    assert sc.obstacles.sum() > 0
    np.testing.assert_array_equal(sc.obstacles, make_mask("cylinder", 16, 32))
    res = run_simulation(sc, RunConfig(variant="jnp"))
    assert np.isfinite(res.av_vels).all()


def test_scene_presets_closed_box():
    from lbm_tpu.tools.scenegen import PRESETS, make_mask

    for preset in PRESETS:
        m = make_mask(preset, 24, 48)
        assert m.shape == (24, 48)
        if preset != "empty":
            assert m[0].all() and m[-1].all()  # exact seam-padding guarantee


def test_check_reports_max_diff_coordinate(tmp_path, capsys):
    """VERDICT r1 #6: final_state max-diff location is printed as the grid
    coordinate from the file's first two columns, like the reference
    (check/check.py:120-129), not a flat index."""
    from lbm_tpu.tools import check

    def fs_lines(vals):
        # 4x2 grid: lines "ii jj ux uy |u| pressure obst"
        out = []
        i = 0
        for jj in range(2):
            for ii in range(4):
                out.append(f"{ii} {jj} 0 0 0 {vals[i]:.12E} 0\n")
                i += 1
        return "".join(out)

    ref_vals = [1.0] * 8
    sim_vals = list(ref_vals)
    sim_vals[6] = 1.5  # coord ii=2, jj=1
    (tmp_path / "ref_fs.dat").write_text(fs_lines(ref_vals))
    (tmp_path / "sim_fs.dat").write_text(fs_lines(sim_vals))
    (tmp_path / "ref_av.dat").write_text("0:\t1.0\n")
    (tmp_path / "sim_av.dat").write_text("0:\t1.0\n")

    rc = check.main([
        "--ref-av-vels-file", str(tmp_path / "ref_av.dat"),
        "--ref-final-state-file", str(tmp_path / "ref_fs.dat"),
        "--av-vels-file", str(tmp_path / "sim_av.dat"),
        "--final-state-file", str(tmp_path / "sim_fs.dat"),
    ])
    out = capsys.readouterr().out
    assert "(at coord (2,1))" in out
    assert rc == 1  # 50% diff fails the 1% tolerance


def test_divergence_probe(tmp_path, small_params, small_obstacles):
    """VERDICT r1 #9: the sync-vs-async divergence probe emits a per-step
    deviation curve; step 0 is exact (fresh init exchange) and later steps
    deviate but stay bounded."""
    from lbm_tpu.io.scene import Scene
    from lbm_tpu.tools import divergence

    scene = Scene(
        params=small_params.replace(max_iters=20), obstacles=small_obstacles
    )
    res = divergence.run_divergence(scene, num_devices=2, staleness=1)
    assert len(res.av_sync) == 20
    assert res.field_rel_linf[0] == 0.0  # first exchange is fresh
    assert res.field_rel_linf[-1] > 0.0  # stale halos do deviate
    assert np.isfinite(res.field_rel_linf).all()
    assert np.nanmax(res.av_rel_pct) < 5.0

    csv = tmp_path / "divergence.csv"
    divergence.write_csv(csv, res)
    lines = csv.read_text().splitlines()
    assert lines[0].startswith("step,av_sync")
    assert len(lines) == 21
    png = tmp_path / "divergence.png"
    divergence.write_plot(png, res)
    assert png.stat().st_size > 0


@pytest.mark.parametrize("storage,min_bytes", [("f32", 73), ("i16", 37)])
def test_steptrace_on_cpu_reports_no_device(storage, min_bytes):
    """The trace reducer reads device planes only: on a CPU it says there
    is none instead of reporting host threads as device time, and still
    gives the least bytes a step moves for the storage."""
    from lbm_tpu.parallel import modes
    from lbm_tpu.params import LBMParams
    from lbm_tpu.tools import steptrace

    p = LBMParams(nx=32, ny=16, max_iters=4, reynolds_dim=10,
                  density=0.1, accel=0.005, omega=1.85)
    mask = np.zeros((16, 32), dtype=bool)
    mask[0, :] = mask[-1, :] = True
    prog = modes.build_single_program(p, mask, storage=storage)
    res = steptrace.trace_program(prog, 4)
    assert res["device_planes"] == 0
    assert res["min_bytes_per_cell_step"] == min_bytes
    assert res["xla_bytes_per_cell_step"] > 0


def test_stream_rate_counts_one_read_and_one_write_per_pass():
    from lbm_tpu.tools import steptrace

    res = steptrace.stream_rate((9, 8, 16), reps=2, repeats=1)
    assert res["bytes_per_pass"] == 2 * 9 * 8 * 16 * 4
    assert res["seconds_per_pass"] > 0 and res["gb_per_s"] > 0


def test_steptrace_busy_time_is_the_interval_union():
    from lbm_tpu.tools import steptrace

    assert steptrace._union_ns([(0, 10), (5, 15), (20, 30)]) == 25
    assert steptrace._union_ns([(0, 10), (2, 3)]) == 10
    assert steptrace._union_ns([]) == 0
