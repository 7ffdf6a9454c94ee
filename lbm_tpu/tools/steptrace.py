"""Trace the timestep scan and reduce the trace to per-step device metrics.

``trace_program(program, steps)`` compiles the driver's scan for ``steps``
steps, runs it once to warm up, runs it again under ``jax.profiler.trace``
and reads the ``.xplane.pb`` back with ``jax.profiler.ProfileData``.  From
the device plane it reports, per step:

- the kernels launched (their count and names: each XLA fusion, library
  call or Pallas kernel is one event);
- device busy time (the union of kernel intervals) and the idle share of
  the traced window;
- bytes accessed per cell and step: XLA's cost analysis of one step, and
  the least any step can move (9 planes read and written, the mask read),
  with the rate that least traffic implies over the busy time (a lower
  bound on the traffic, not a measured one).

``stream_rate(shape)`` measures the device's read+write rate on a plain
elementwise pass, the reference that lower bound is compared with.

Device planes exist only where there is a device (a GPU); on the CPU the
result says so rather than reporting host threads as device time.
"""

from __future__ import annotations

import collections
import glob
import os
import tempfile

import jax


def _device_planes(profile):
    return [p for p in profile.planes if p.name.startswith("/device:GPU")]


def _union_ns(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(path: str, steps: int) -> dict:
    """Per-step kernel counts, busy and idle time from one xplane file."""
    profile = jax.profiler.ProfileData.from_file(path)
    planes = _device_planes(profile)
    if not planes:
        return {"device_planes": 0}
    plane = planes[0]
    line_names = [line.name for line in plane.lines]
    kernels = []
    for line in plane.lines:
        # Kernel events live on the stream lines; the module/step summary
        # lines ("XLA Modules", "Steps", ...) repeat them at a coarser grain.
        if "stream" not in line.name.lower():
            continue
        kernels.extend(line.events)
    if not kernels:
        return {"device_planes": len(planes), "kernels": 0, "lines": line_names}
    start = min(e.start_ns for e in kernels)
    end = max(e.end_ns for e in kernels)
    busy = _union_ns((e.start_ns, e.end_ns) for e in kernels)
    by_name = collections.Counter()
    ns_by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += 1
        ns_by_name[e.name] += e.duration_ns
    top = sorted(ns_by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "device_planes": len(planes),
        "lines": line_names,
        "kernels": len(kernels),
        "kernels_per_step": len(kernels) / steps,
        "window_us": (end - start) / 1e3,
        "busy_us_per_step": busy / steps / 1e3,
        "idle_share": 1.0 - busy / max(end - start, 1),
        "top_kernels": [
            {"name": n, "count": by_name[n], "us_per_step": ns / steps / 1e3}
            for n, ns in top
        ],
    }


def trace_program(program, steps: int, out_dir: str | None = None) -> dict:
    """Trace ``steps`` steps of ``program`` under the driver's scan (into
    ``out_dir``, or a temporary directory removed afterwards).

    The scan copies its input into the loop carry once per call, so a short
    window overstates the busy time and the idle share per step; trace as
    many steps as a timed run takes (thousands at 1024²)."""
    from lbm_tpu.tools.bench import compile_scan

    state = program.init_state
    exe = compile_scan(program, steps)
    # XLA's own estimate of the bytes ONE step accesses (a Pallas kernel is
    # opaque to it and counts as nothing).
    cost = jax.jit(program.step).lower(state).compile().cost_analysis() or {}
    if isinstance(cost, list):  # older jax returns one dict per module
        cost = cost[0] if cost else {}
    jax.block_until_ready(exe(state))
    if out_dir is None:
        with tempfile.TemporaryDirectory(prefix="lbm_trace_") as tmp:
            result = _traced_run(exe, state, steps, tmp)
    else:
        result = _traced_run(exe, state, steps, out_dir)
    ny, nx = program.global_shape
    cells = ny * nx
    itemsize = jax.tree.leaves(state)[0].dtype.itemsize
    # The least a step can move: read and write 9 planes, read the mask.
    min_bytes = 2 * 9 * itemsize + 1
    result["xla_bytes_per_cell_step"] = float(cost.get("bytes accessed", 0.0)) / cells
    result["min_bytes_per_cell_step"] = min_bytes
    if result.get("busy_us_per_step"):
        # The rate the least traffic implies over the device busy time.
        result["min_gb_per_s"] = (
            min_bytes * cells / (result["busy_us_per_step"] * 1e-6) / 1e9
        )
    return result


def stream_rate(shape, reps: int = 20, repeats: int = 5) -> dict:
    """Read+write rate of the device on a float32 array of ``shape``: the
    reference a memory-bound step's rate is held against, taken in the same
    process (same card, same power limit).

    ``y <- y + 1`` runs ``reps`` and ``2*reps`` times in one compiled loop;
    the difference of the two median wall times cancels the launch, the
    copy into the loop carry and the host's share, leaving ``reps`` passes
    that each read and write the whole array."""
    import statistics
    import time

    import jax.numpy as jnp

    x = jnp.ones(shape, jnp.float32)

    def body(i, a):
        # The barrier keeps XLA from fusing passes should it unroll the loop.
        return jax.lax.optimization_barrier(a + jnp.float32(1.0))

    def passes(n):
        return jax.jit(
            lambda y: jax.lax.fori_loop(0, n, body, y)).lower(x).compile()

    med = {}
    for n in (reps, 2 * reps):
        exe = passes(n)
        jax.block_until_ready(exe(x))
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(exe(x))
            times.append(time.perf_counter() - t0)
        med[n] = statistics.median(times)
    seconds = max(med[2 * reps] - med[reps], 1e-12)
    nbytes = 2 * x.size * x.dtype.itemsize * reps
    return {
        "bytes_per_pass": 2 * x.size * x.dtype.itemsize,
        "seconds_per_pass": seconds / reps,
        "gb_per_s": nbytes / seconds / 1e9,
    }


def _traced_run(exe, state, steps: int, out_dir: str) -> dict:
    with jax.profiler.trace(out_dir):
        jax.block_until_ready(exe(state))
    files = glob.glob(os.path.join(out_dir, "**", "*.xplane.pb"), recursive=True)
    if not files:
        raise RuntimeError(f"no xplane.pb under {out_dir}")
    return reduce_trace(max(files, key=os.path.getmtime), steps)
