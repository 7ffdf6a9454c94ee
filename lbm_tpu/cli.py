"""Command-line interface.

``python -m lbm_tpu run <paramfile> <obstaclefile>`` mirrors the reference
binary's invocation (SerialCode/d2q9-bgk.c:45-52) and its stdout report
(==done==, Reynolds number, phase timings, SerialCode/d2q9-bgk.c:195-200),
then writes ``final_state.dat`` and ``av_vels.dat``.  Additional subcommands
cover validation (``check``, the check.py analog), benchmarking (``bench``),
and visualization (``viz``, ``animate``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _add_run_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("paramfile")
    p.add_argument("obstaclefile")
    p.add_argument(
        "--variant",
        default="auto",
        help="solver variant: serial | jnp | pallas | sync | overlap | async | "
        "async-k | chunked | ca (aliases: openmp, mpi, waitall, testall); "
        "default auto.  ca = communication-avoiding: one K-deep halo "
        "exchange per K steps, bitwise-exact vs sync",
    )
    p.add_argument("--devices", type=int, default=None, help="mesh size for sharded variants")
    p.add_argument(
        "--staleness", type=int, default=None,
        help="halo age for async variants / chunk length for chunked / "
        "exchange depth K for ca (default: async 1, async-k 2, chunked 2, "
        "ca 4)",
    )
    p.add_argument(
        "--backend", choices=["jnp", "pallas"], default=None,
        help="per-step compute: jnp (the XLA-fused step) or pallas (the "
        "Triton block kernel; GPU only); default auto",
    )
    p.add_argument(
        "--storage", choices=["f32", "i16"], default="f32",
        help="state representation in device memory: f32 (exact) or i16 "
        "fixed-point deviations (half the memory traffic, quantized after "
        "every step)",
    )
    p.add_argument("--steps", type=int, default=None, help="override maxIters")
    p.add_argument("--frame-interval", type=int, default=None, help="capture |u| every k steps")
    p.add_argument("--out-dir", default=".", help="output directory")
    p.add_argument("--final-state-file", default="final_state.dat")
    p.add_argument("--av-vels-file", default="av_vels.dat")
    p.add_argument("--no-output", action="store_true", help="skip writing result files")
    p.add_argument("--checkpoint-every", type=int, default=None,
                   help="save a resumable state checkpoint every N steps")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--resume", default=None, help="checkpoint .npz to resume from")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax profiler trace of the compute phase")
    p.add_argument(
        "--segment-steps", type=int, default=None,
        help="execute as fixed-N-step compiled segments so the executable "
        "is independent of --steps and the persistent compilation cache "
        "hits across runs (default: auto; 0 = one whole-run executable)",
    )
    p.add_argument(
        "--plan", action="store_true",
        help="print the execution plan (variant, step, discipline, "
        "segment layout) and exit without running",
    )
    p.add_argument(
        "--divergence",
        action="store_true",
        help="run sync and async side by side and emit the per-step "
        "deviation curve (divergence.csv/.png in --out-dir) instead of a "
        "normal run — quantifies the stale-halo accuracy trade the "
        "reference README claims (README.md:9-13)",
    )
    p.add_argument(
        "--debug",
        action="store_true",
        help="print per-step av velocity and total density (the reference's "
        "DEBUG build, SerialCode/d2q9-bgk.c:175-179)",
    )
    p.add_argument(
        "--platform",
        default=None,
        help="force a jax platform (e.g. cpu); with cpu, --host-devices N "
        "creates N virtual devices for sharded variants",
    )
    p.add_argument("--host-devices", type=int, default=None)


def _apply_platform(platform: str | None, host_devices: int | None) -> None:
    """Force the jax platform before any backend initialisation (e.g.
    ``--platform cpu --host-devices 8`` for a virtual 8-device mesh)."""
    if host_devices:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={host_devices}"
            ).strip()
    if platform:
        import jax

        jax.config.update("jax_platforms", platform)


def cmd_run(args: argparse.Namespace) -> int:
    from lbm_tpu.io import load_scene, write_av_vels, write_final_state
    from lbm_tpu.models.driver import RunConfig, run_simulation

    _apply_platform(args.platform, args.host_devices)
    scene = load_scene(args.paramfile, args.obstaclefile)
    if args.divergence:
        from lbm_tpu.tools.divergence import run_divergence, write_csv, write_plot

        res = run_divergence(
            scene,
            num_devices=args.devices,
            staleness=args.staleness if args.staleness is not None else 1,
            num_steps=args.steps,
            backend=args.backend or "jnp",
        )
        os.makedirs(args.out_dir, exist_ok=True)
        csv_path = os.path.join(args.out_dir, "divergence.csv")
        write_csv(csv_path, res)
        print(res.summary())
        print(f"wrote {csv_path}")
        try:
            png_path = os.path.join(args.out_dir, "divergence.png")
            write_plot(png_path, res)
            print(f"wrote {png_path}")
        except ImportError:
            pass
        return 0
    config = RunConfig(
        variant=args.variant,
        num_devices=args.devices,
        staleness=args.staleness,
        num_steps=args.steps,
        frame_interval=args.frame_interval,
        backend=args.backend,
        storage=args.storage,
        debug=args.debug,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
        resume_from=args.resume,
        profile_dir=args.profile,
        segment_steps=args.segment_steps,
    )
    if args.plan:
        from lbm_tpu.models.plan import describe_plan

        print(describe_plan(scene, config))
        return 0

    import jax

    # Device banner (the analog of the reference's per-rank banner,
    # MPI/d2q9-bgk.c:151).
    devs = jax.devices()
    print(f"lbm_tpu: backend={jax.default_backend()} devices={len(devs)} ({devs[0].device_kind})")

    result = run_simulation(scene, config)

    print("==done==")
    print(f"Variant:\t\t\t{result.variant}")
    print("Reynolds number:\t\t%.12E" % result.reynolds)
    print(result.timer.report())
    print("Compute rate:\t\t\t%.1f MLUPS" % result.mlups)

    if not args.no_output:
        os.makedirs(args.out_dir, exist_ok=True)
        write_final_state(
            os.path.join(args.out_dir, args.final_state_file),
            result.f,
            scene.obstacles,
            scene.params,
        )
        write_av_vels(os.path.join(args.out_dir, args.av_vels_file), result.av_vels)
        if result.frames is not None:
            from lbm_tpu.tools.animation import write_frame_files

            write_frame_files(
                os.path.join(args.out_dir, "animation_data"),
                result.frames,
                result.frame_steps,
                scene.params,
            )
    return 0


def cmd_check(argv: list[str]) -> int:
    from lbm_tpu.tools.check import main as check_main

    return check_main(argv)


def cmd_bench(args: argparse.Namespace) -> int:
    _apply_platform(args.platform, args.host_devices)
    from lbm_tpu.tools.bench import run_bench

    report = run_bench(
        grid=args.grid,
        variant=args.variant,
        steps=args.steps,
        devices=args.devices,
        repeats=args.repeats,
        storage=args.storage,
    )
    print(json.dumps(report))
    return 0


def cmd_viz(args: argparse.Namespace) -> int:
    from lbm_tpu.tools.visualize import render_final_state

    out = render_final_state(args.final_state, args.output, obstacle_outline=True)
    print(f"wrote {out}")
    return 0


def cmd_animate(args: argparse.Namespace) -> int:
    from lbm_tpu.tools.animation import animate_directory

    out = animate_directory(args.frames_dir, args.output, fps=args.fps)
    print(f"wrote {out}")
    if args.preview:
        # Reference emits a reduced key-frame preview GIF alongside the full
        # one (Visualization/animation.py:139-198: every 20th frame, 3 fps).
        root, ext = os.path.splitext(args.output)
        pv = animate_directory(
            args.frames_dir, f"{root}_preview{ext or '.gif'}", fps=3, every=20
        )
        print(f"wrote {pv} (preview, every 20th frame)")
    return 0


def cmd_golden(args: argparse.Namespace) -> int:
    """Regenerate golden data for a scene (the mirror lacks the two largest
    final_state goldens, .MISSING_LARGE_BLOBS; this recreates them)."""
    from lbm_tpu.io import load_scene, write_av_vels, write_final_state
    from lbm_tpu.models.driver import RunConfig, run_simulation

    _apply_platform(args.platform, None)
    scene = load_scene(args.paramfile, args.obstaclefile)
    result = run_simulation(
        scene, RunConfig(variant=args.variant, num_steps=args.steps)
    )
    os.makedirs(args.out_dir, exist_ok=True)
    tag = f"{scene.params.nx}x{scene.params.ny}"
    av_path = os.path.join(args.out_dir, f"{tag}.av_vels.dat")
    fs_path = os.path.join(args.out_dir, f"{tag}.final_state.dat")
    write_av_vels(av_path, result.av_vels)
    write_final_state(fs_path, result.f, scene.obstacles, scene.params)
    print(f"wrote {av_path} and {fs_path} (variant={result.variant})")
    return 0


def cmd_sweep(args: argparse.Namespace) -> int:
    """Batched parameter sweep: B variants of one scene in one compiled
    program (jax.vmap over omega/accel; tools/ensemble.py)."""
    from lbm_tpu.io import load_scene, write_av_vels
    from lbm_tpu.tools.ensemble import parse_range, run_ensemble

    _apply_platform(args.platform, args.host_devices)
    scene = load_scene(args.paramfile, args.obstaclefile)
    omegas = parse_range(args.omega or str(scene.params.omega))
    accels = parse_range(args.accel) if args.accel else None

    # Resolve the instance count FIRST (geometries fix it when present),
    # then broadcast each parameter spec against it.
    obstacles = scene.obstacles
    if args.geometry:
        # Geometry sweep: the base obstacle file plus each --geometry file
        # becomes one instance (all on the base grid).
        masks = [scene.obstacles]
        for path in args.geometry:
            masks.append(load_scene(args.paramfile, path).obstacles)
        obstacles = np.stack(masks)
        B = len(masks)
    else:
        B = max(omegas.size, accels.size if accels is not None else 1)

    def fit(name, vals):
        if vals.size == 1:
            return np.repeat(vals, B)
        if vals.size != B:
            raise ValueError(
                f"{name} has {vals.size} values but the sweep has {B} "
                "instances; pass one value or one per instance"
            )
        return vals

    omegas = fit("--omega", omegas)
    if accels is not None:
        accels = fit("--accel", accels)
    res = run_ensemble(
        scene.params, obstacles, omegas, accels, num_steps=args.steps
    )
    os.makedirs(args.out_dir, exist_ok=True)
    summary = os.path.join(args.out_dir, "sweep_summary.dat")
    final_av = (
        res.av_vels[-1]
        if res.av_vels.shape[0]
        else np.full(res.omegas.size, np.nan, dtype=np.float32)
    )
    with open(summary, "w") as fh:
        fh.write("# idx omega accel reynolds final_av_velocity\n")
        for i in range(res.omegas.size):
            fh.write(
                f"{i:d} {res.omegas[i]:.6f} {res.accels[i]:.6f} "
                f"{res.reynolds[i]:.12E} {final_av[i]:.12E}\n"
            )
    if args.av_vels:
        for i in range(res.omegas.size):
            write_av_vels(
                os.path.join(args.out_dir, f"av_vels_{i:03d}.dat"),
                res.av_vels[:, i],
            )
    if args.plot:
        from lbm_tpu.tools.ensemble import render_sweep

        render_sweep(res, os.path.join(args.out_dir, "sweep.png"))
    print(
        f"swept {res.omegas.size} variants x {res.av_vels.shape[0]} steps "
        f"in one compiled program; wrote {summary}"
        + (" and sweep.png" if args.plot else "")
    )
    return 0


def cmd_speedup(args: argparse.Namespace) -> int:
    from lbm_tpu.tools.speedup import main as speedup_main

    return speedup_main(args.reports + ["--output", args.output])


def cmd_info(args: argparse.Namespace) -> int:
    _apply_platform(args.platform, args.host_devices)
    import jax

    print(f"jax {jax.__version__}, backend={jax.default_backend()}")
    for d in jax.devices():
        print(f"  {d.id}: {d.device_kind} ({d.platform})")
    from lbm_tpu.io import native

    print(f"native io: {'available' if native.available() else 'not built (make native)'}")
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    from lbm_tpu.utils.compcache import enable_persistent_cache

    enable_persistent_cache()
    parser = argparse.ArgumentParser(prog="lbm_tpu", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    p_run = sub.add_parser("run", help="run a simulation scene")
    _add_run_args(p_run)

    sub.add_parser("check", help="validate outputs against reference results", add_help=False)

    p_bench = sub.add_parser("bench", help="benchmark a grid/variant")
    p_bench.add_argument("--grid", default="1024x1024")
    p_bench.add_argument("--variant", default="auto")
    p_bench.add_argument("--steps", type=int, default=None)
    p_bench.add_argument("--devices", type=int, default=None)
    p_bench.add_argument("--repeats", type=int, default=3)
    p_bench.add_argument("--storage", choices=["f32", "i16"], default="f32")
    p_bench.add_argument("--platform", default=None)
    p_bench.add_argument("--host-devices", type=int, default=None)

    p_viz = sub.add_parser("viz", help="render 4-panel plots from final_state.dat")
    p_viz.add_argument("final_state")
    p_viz.add_argument("--output", default="final_state.png")

    p_anim = sub.add_parser("animate", help="build a GIF from animation frames")
    p_anim.add_argument("frames_dir")
    p_anim.add_argument("--output", default="animation.gif")
    p_anim.add_argument("--fps", type=int, default=10)
    p_anim.add_argument(
        "--preview", action="store_true",
        help="also emit a reduced key-frame preview GIF (every 20th frame)",
    )

    p_gold = sub.add_parser("golden", help="regenerate golden data for a scene")
    p_gold.add_argument("paramfile")
    p_gold.add_argument("obstaclefile")
    p_gold.add_argument("--out-dir", default="golden")
    p_gold.add_argument("--variant", default="jnp")
    p_gold.add_argument("--steps", type=int, default=None)
    p_gold.add_argument("--platform", default=None)

    p_sweep = sub.add_parser(
        "sweep", help="batched omega/accel parameter sweep (one compiled program)"
    )
    p_sweep.add_argument("paramfile")
    p_sweep.add_argument("obstaclefile")
    p_sweep.add_argument(
        "--omega", default=None,
        help="relaxation values: a:b:n (linspace), a,b,c (list), or scalar",
    )
    p_sweep.add_argument(
        "--accel", default=None,
        help="acceleration values (same specs); broadcast against --omega",
    )
    p_sweep.add_argument(
        "--geometry", action="append", default=None, metavar="OBSTACLEFILE",
        help="additional obstacle files for a geometry sweep (the base "
        "obstacle file is instance 0; repeatable)",
    )
    p_sweep.add_argument("--steps", type=int, default=None)
    p_sweep.add_argument("--out-dir", default="sweep")
    p_sweep.add_argument(
        "--av-vels", action="store_true",
        help="also write per-instance av_vels_XXX.dat series",
    )
    p_sweep.add_argument(
        "--plot", action="store_true",
        help="render sweep.png (av_vels families + final-value curve)",
    )
    p_sweep.add_argument("--platform", default=None)
    p_sweep.add_argument("--host-devices", type=int, default=None)

    p_speed = sub.add_parser("speedup", help="render a speedup plot from bench reports")
    p_speed.add_argument("reports", nargs="+")
    p_speed.add_argument("--output", default="speedup.png")

    sub.add_parser(
        "scene", help="generate a scene (cavity/channel/cylinder)", add_help=False
    )
    p_info = sub.add_parser("info", help="print device/runtime info")
    p_info.add_argument("--platform", default=None)
    p_info.add_argument("--host-devices", type=int, default=None)

    # `check` and `scene` forward unparsed args to their own parsers.
    if argv and argv[0] == "check":
        return cmd_check(argv[1:])
    if argv and argv[0] == "scene":
        from lbm_tpu.tools.scenegen import main as scene_main

        try:
            return scene_main(argv[1:])
        except (OSError, ValueError) as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1

    args = parser.parse_args(argv)
    handler = {
        "run": cmd_run,
        "bench": cmd_bench,
        "viz": cmd_viz,
        "animate": cmd_animate,
        "golden": cmd_golden,
        "sweep": cmd_sweep,
        "speedup": cmd_speedup,
        "info": cmd_info,
    }[args.command]
    try:
        return handler(args)
    except (OSError, ValueError) as e:
        # The reference die()s with a message and exit(1)
        # (SerialCode/d2q9-bgk.c:745-751).
        print(f"Error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
