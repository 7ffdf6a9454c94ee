#!/usr/bin/env python3
"""GPU smoke run: the quickest proof that the solver runs on the card.

    python chip_smoke.py              # one GPU: phases device, f32, i16, kernels
    python chip_smoke.py --devices 4  # four GPUs: the sharded phase only

Phases (one process; ``lbm_tpu.cli.main`` is called in-process, because a
second JAX process could not open a card this one already holds):

- device:  JAX devices, the card's name and power limit (nvidia-smi),
           XLA_FLAGS and the JAX version;
- f32:     the 1024x1024 reference scene (golden/), 20000 steps, through
           ``run`` in auto mode, then ``check`` against golden/1024x1024.*
           at the reference's 1% tolerance;
- i16:     the same with ``--storage i16``;
- kernels: the XLA step and the Triton block kernel against the NumPy
           oracle (128x128, 12 steps), the kernel against the XLA step
           (1024x1024 and 8192x8192, f32 and i16, 100 steps) with both
           timings, a profiler trace of each as long as its timed run, and
           the card's stream rate as the reference for the 8192x8192 kernel;
- sharded (``--devices N``, N > 1): every discipline against the
           single-device XLA run on a small scene, then the 1024x1024 scene
           through ``run --devices N`` (auto picks ca) and ``check``.

Any failing phase raises, so the script exits non-zero.  The last line of
standard output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
JAX is held to the CUDA platform: with no GPU the script fails rather than
fall back to the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))
SCENE = ("golden/input_1024x1024.params", "golden/obstacles_1024x1024.dat")
GOLDEN = ("golden/1024x1024.av_vels.dat.gz", "golden/1024x1024.final_state.dat.gz")

# XLA step and kernel vs the NumPy oracle after 12 steps at 128x128.  Not
# bitwise: the
# GPU contracts multiply-adds into FMAs, and the float32 |u| sum over 16k
# cells runs in another order (already 2.6e-5 relative between XLA and
# NumPy on the CPU), so av takes the repo's oracle tolerance
# (tests/test_driver.py).
ORACLE_FIELD_ATOL = 1e-6
ORACLE_AV_RTOL = 1e-4
# Block kernel vs XLA step after 100 steps: the same per-cell expression
# tree, compiled by two compilers (FMA contraction may differ); i16 adds
# rounding flips of one quantization step (~3e-6) that then propagate.
KERNEL_ATOL = {"f32": 1e-5, "i16": 5e-5}
KERNEL_AV_RTOL = {"f32": 1e-4, "i16": 5e-4}


def _say(msg: str = "") -> None:
    print(msg, flush=True)


def _card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def _cli(argv: list[str]) -> str:
    """Run ``lbm_tpu.cli.main(argv)`` in-process; echo and return its
    stdout; raise on a non-zero exit."""
    from lbm_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    text = buf.getvalue()
    sys.stdout.write(text)
    sys.stdout.flush()
    if rc != 0:
        raise RuntimeError(f"lbm_tpu {' '.join(argv)} exited {rc}")
    return text


def _field(text: str, label: str) -> str:
    m = re.search(rf"^{re.escape(label)}:\s*(.+)$", text, re.M)
    if m is None:
        raise RuntimeError(f"no {label!r} line in the run report")
    return m.group(1).strip()


def phase_main_path(card: str, storage: str, devices: int | None = None) -> dict:
    """The reference scene through ``run`` (auto) and ``check``."""
    out_dir = tempfile.mkdtemp(prefix=f"smoke_{storage}_")
    argv = ["run", *SCENE, "--out-dir", out_dir, "--storage", storage]
    if devices:
        argv += ["--devices", str(devices)]
    text = _cli(argv)
    check = _cli([
        "check",
        "--ref-av-vels-file", GOLDEN[0],
        "--ref-final-state-file", GOLDEN[1],
        "--av-vels-file", os.path.join(out_dir, "av_vels.dat"),
        "--final-state-file", os.path.join(out_dir, "final_state.dat"),
    ])
    if "Both tests passed!" not in check:
        raise RuntimeError(f"{storage} run failed the 1% golden check")
    res = {
        "storage": storage,
        "variant": _field(text, "Variant"),
        "init_s": float(_field(text, "Elapsed Init time").split()[0]),
        "compute_s": float(_field(text, "Elapsed Compute time").split()[0]),
        "collate_s": float(_field(text, "Elapsed Collate time").split()[0]),
        "mlups": float(_field(text, "Compute rate").split()[0]),
    }
    _say(f"main path {storage}"
         + (f" on {devices} devices" if devices else "")
         + f": variant={res['variant']} init={res['init_s']}s "
         f"compute={res['compute_s']}s collate={res['collate_s']}s "
         f"MLUPS={res['mlups']}  [{card}]  golden check passed (1%)")
    return res


def _closed_box(ny: int, nx: int, steps: int, accel: float):
    import numpy as np

    from lbm_tpu.io.scene import Scene
    from lbm_tpu.params import LBMParams

    params = LBMParams(nx=nx, ny=ny, max_iters=steps, reynolds_dim=10,
                       density=0.1, accel=accel, omega=1.85)
    mask = np.zeros((ny, nx), dtype=bool)
    mask[0, :] = mask[-1, :] = True
    mask[:, 0] = mask[:, -1] = True
    mask[ny // 3: ny // 3 + ny // 8, nx // 2: nx // 2 + nx // 16] = True
    return Scene(params=params, obstacles=mask)


def _run_program(program, steps: int):
    import jax
    import numpy as np

    from lbm_tpu.tools.bench import compile_scan

    state, tots, _ = compile_scan(program, steps)(program.init_state)
    f = np.asarray(jax.device_get(program.f_of(state)), np.float32)
    av = np.asarray(jax.device_get(tots), np.float32) / np.float32(
        program.tot_cells)
    return f, av


def phase_oracle() -> None:
    import numpy as np

    from lbm_tpu.core import oracle
    from lbm_tpu.parallel import modes

    steps = 12
    scene = _closed_box(128, 128, steps, 0.005)
    f_ref, av_ref = oracle.run(scene.params, scene.obstacles, num_steps=steps)
    for backend, name in (("jnp", "XLA step"), ("pallas", "Triton kernel")):
        prog = modes.build_single_program(scene.params, scene.obstacles,
                                          backend=backend)
        f, av = _run_program(prog, steps)
        df = float(np.abs(f - f_ref).max())
        dav = float((np.abs(av - av_ref) / np.abs(av_ref)).max())
        if not (df <= ORACLE_FIELD_ATOL and dav <= ORACLE_AV_RTOL):
            raise RuntimeError(
                f"{name} vs oracle: max|df|={df:.3e} (limit "
                f"{ORACLE_FIELD_ATOL}), max rel av={dav:.3e} (limit "
                f"{ORACLE_AV_RTOL})")
        _say(f"oracle: {name} ({backend}) vs NumPy oracle, 128x128, {steps} "
             f"steps: max|df|={df:.3e} (<= {ORACLE_FIELD_ATOL}), max rel "
             f"av={dav:.3e} (<= {ORACLE_AV_RTOL})")


def phase_kernels(card: str) -> None:
    import gc

    import numpy as np

    from lbm_tpu.io import load_scene
    from lbm_tpu.parallel import modes
    from lbm_tpu.tools import steptrace
    from lbm_tpu.tools.bench import time_scan

    steps = 100
    for n, ts in ((1024, 2000), (8192, 200)):
        scene = (load_scene(*SCENE) if n == 1024
                 else _closed_box(n, n, steps, 0.01))
        p, obst = scene.params, scene.obstacles
        for storage in ("f32", "i16"):
            progs = {b: modes.build_single_program(p, obst, backend=b,
                                                   storage=storage)
                     for b in ("jnp", "pallas")}
            f_x, av_x = _run_program(progs["jnp"], steps)
            f_k, av_k = _run_program(progs["pallas"], steps)
            df = float(np.abs(f_k - f_x).max())
            dav = float((np.abs(av_k - av_x) / np.abs(av_x)).max())
            del f_x, f_k
            if not (df <= KERNEL_ATOL[storage]
                    and dav <= KERNEL_AV_RTOL[storage]):
                raise RuntimeError(
                    f"kernel vs XLA {n}^2 {storage}: max|df|={df:.3e} "
                    f"(limit {KERNEL_ATOL[storage]}), rel av={dav:.3e}")
            _say(f"kernel {n}^2 {storage}: Triton block kernel vs XLA step, "
                 f"{steps} steps: max|df|={df:.3e} (<= "
                 f"{KERNEL_ATOL[storage]}), max rel av={dav:.3e} (<= "
                 f"{KERNEL_AV_RTOL[storage]})")
            med = {}
            for b, prog in progs.items():
                t = time_scan(prog, ts, repeats=5)
                med[b] = statistics.median(t)
                _say(f"  timing {n}^2 {storage} {b}: {ts} steps, median of "
                     f"5 = {med[b]:.6f} s ({n * n * ts / med[b] / 1e6:.1f} "
                     f"MLUPS); runs {[round(x, 6) for x in t]}  [{card}]")
            auto = modes.auto_backend("gpu")
            _say(f"  auto uses {auto} at {n}^2 {storage}; pallas/jnp time "
                 f"ratio {med['pallas'] / med['jnp']:.3f}")
            traces = {}
            for b, prog in progs.items():
                # As many steps as the timed run: the scan's one copy of its
                # input into the carry would swamp a short window.
                tr = traces[b] = steptrace.trace_program(prog, ts)
                wall_us = med[b] / ts * 1e6
                _say(f"  trace {n}^2 {storage} {b}: {json.dumps(tr)}")
                if "busy_us_per_step" in tr:
                    _say(f"  trace {n}^2 {storage} {b}: busy "
                         f"{tr['busy_us_per_step']:.3f} us/step vs timed wall "
                         f"{wall_us:.3f} us/step (busy/wall "
                         f"{tr['busy_us_per_step'] / wall_us:.3f})")
            if n == 8192 and storage == "f32":
                ref = steptrace.stream_rate((9, n, n))
                _say(f"  stream reference (9,{n},{n}) f32, y+1 per pass: "
                     f"{json.dumps(ref)}  [{card}]")
                tr = traces["pallas"]
                rates = {"busy": tr.get("min_gb_per_s")}
                for k in tr.get("top_kernels", []):
                    if k["name"] == "lbm_block_step":
                        rates["lbm_block_step"] = (
                            tr["min_bytes_per_cell_step"] * n * n
                            / (k["us_per_step"] * 1e-6) / 1e9)
                for what, rate in rates.items():
                    if rate:
                        _say(f"  kernel least-traffic rate over {what} time "
                             f"{rate:.1f} GB/s = {rate / ref['gb_per_s']:.3f} "
                             f"of the stream reference")
            del progs
            gc.collect()


def phase_sharded(card: str, n_dev: int) -> None:
    import __graft_entry__ as graft

    checked = graft._dryrun_impl(n_dev)
    _say(f"sharded: {checked} discipline relations hold on {n_dev} devices")
    phase_main_path(card, "f32", devices=n_dev)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="N > 1 runs the N-device sharded phase only")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(REPO, "lbm_tpu")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    os.chdir(REPO)
    sys.path.insert(0, REPO)
    # Native output writer (a Python fallback exists); built before JAX.
    mk = subprocess.run(["make", "-s", "native"], capture_output=True,
                        text=True)
    if mk.returncode:
        _say(f"make native failed (rc={mk.returncode}); the Python writer "
             "is used")

    import jax

    jax.config.update("jax_platforms", "cuda")
    devs = jax.devices()
    card = _card_info()
    for line in card.splitlines():
        _say(f"nvidia-smi: {line}")
    card = card.splitlines()[0]
    _say(f"jax {jax.__version__}; devices: {devs}; kind "
         f"{devs[0].device_kind}; count {len(devs)}")
    _say(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")

    if args.devices > 1:
        if len(devs) < args.devices:
            raise RuntimeError(
                f"--devices {args.devices} needs {args.devices} GPUs, "
                f"found {len(devs)}")
        phase_sharded(card, args.devices)
    else:
        for storage in ("f32", "i16"):
            phase_main_path(card, storage)
        phase_oracle()
        phase_kernels(card)

    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
