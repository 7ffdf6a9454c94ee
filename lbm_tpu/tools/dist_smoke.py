"""Multi-process (multi-controller) smoke run over jax.distributed.

The reference's flagship configuration is 2 nodes x 40 MPI ranks
(MPI/job_submit_d2q9-bgk:4-6).  This module is the framework's multi-process
validation path: each participating process initializes jax.distributed,
joins a global row mesh spanning every process's devices, runs the sync
discipline on a small closed-box scene, and checks the collated result
bitwise against a locally computed single-device reference.

Used by ``scripts/run_pod.sh --dryrun`` (2 local CPU processes) and by
``tests/test_distributed.py``.
"""

from __future__ import annotations

import argparse
import os
import sys


def worker(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="distributed smoke worker")
    parser.add_argument("--process-id", type=int, required=True)
    parser.add_argument("--num-processes", type=int, required=True)
    parser.add_argument("--coordinator", default="127.0.0.1:12421")
    parser.add_argument("--local-devices", type=int, default=4)
    parser.add_argument("--steps", type=int, default=12)
    parser.add_argument("--mode", default="sync")
    args = parser.parse_args(argv)

    # Device count must be forced before the backend initializes.
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count="
            f"{args.local_devices}"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )
    n_global = args.local_devices * args.num_processes
    assert jax.device_count() == n_global, (
        f"expected {n_global} global devices, found {jax.device_count()}"
    )
    assert jax.local_device_count() == args.local_devices

    import numpy as np

    from lbm_tpu.params import LBMParams
    from lbm_tpu.parallel import mesh as mesh_lib
    from lbm_tpu.parallel import modes

    if args.mode == "ca":
        # ca exchanges K=2 rows each way: >= 2 rows per shard.
        ny, nx = 2 * n_global, 16
        staleness = 2
    else:
        ny = nx = 16
        staleness = 1
    params = LBMParams(
        nx=nx, ny=ny, max_iters=args.steps, reynolds_dim=10,
        density=0.1, accel=0.005, omega=1.85,
    )
    mask = np.zeros((ny, nx), dtype=bool)
    mask[0, :] = mask[-1, :] = True
    mask[:, 0] = mask[:, -1] = True

    mesh = mesh_lib.make_row_mesh(n_global)
    prog = modes.build_sharded_program(
        params, mask, mesh, mode=args.mode, staleness=staleness,
    )
    step = jax.jit(prog.step)
    state = prog.init_state
    for _ in range(args.steps // prog.steps_per_call):
        state, tot_u = step(state)
    steps_run = (args.steps // prog.steps_per_call) * prog.steps_per_call

    # Replicate the global result so every process holds the full field.
    from jax.sharding import NamedSharding, PartitionSpec as P

    replicate = jax.jit(
        lambda a: a, out_shardings=NamedSharding(mesh, P(None, None, None))
    )
    f_full = np.asarray(replicate(prog.f_of(state)).addressable_shards[0].data)

    # Local single-device reference (identical on every process).
    sprog = modes.build_single_program(params, mask, backend="jnp")
    sstep = jax.jit(sprog.step)
    f_ref = sprog.init_state
    for _ in range(steps_run):
        f_ref, _ = sstep(f_ref)
    f_ref = np.asarray(f_ref)

    if args.mode in ("sync", "overlap", "ca"):
        if not np.array_equal(f_full, f_ref):
            print(
                f"process {args.process_id}: MISMATCH "
                f"max|diff|={np.abs(f_full - f_ref).max()}",
                file=sys.stderr,
            )
            return 1
    else:
        rel = np.abs(f_full - f_ref).max() / np.abs(f_ref).max()
        if not (np.isfinite(rel) and rel < 0.05):
            print(f"process {args.process_id}: deviation {rel}", file=sys.stderr)
            return 1

    # Multi-step programs (ca) return a (K,) tot vector; report the last step.
    tot_last = float(np.asarray(tot_u).reshape(-1)[-1])
    print(
        f"DIST_SMOKE_OK process={args.process_id}/{args.num_processes} "
        f"devices={n_global} mode={args.mode} tot_u={tot_last:.6e}",
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(worker())
