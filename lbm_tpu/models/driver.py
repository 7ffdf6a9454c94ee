"""Simulation driver: the on-device timestep loop and its orchestration.

The analog of the reference's ``main()`` (SerialCode/d2q9-bgk.c:132-205,
MPI/d2q9-bgk.c:130-331): initialise, run the timestep loop, collate, report,
write.  The entire ``max_iters`` loop runs on device under ``lax.scan`` with the
per-step av_velocity reduction fused in, so the host touches data exactly
twice (init upload, final download).  Optional
animation frames are captured on device into a preallocated buffer during the
scan and flushed afterwards — the deterministic equivalent of the reference's
rank-local RAM frame cache that defers all I/O until after the timed loop
(MPI_Testall_OptimizedVersion/d2q9-bgk.c:130-146, 1093-1273).  Like the
reference, capture lives INSIDE the timed loop: the run executes as
inter-frame segments of the program's own advance (chunked programs through
their exchange/inner primitives), paying one |u| evaluation per frame rather
than per step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from lbm_tpu.core import oracle
from lbm_tpu.io.scene import Scene
from lbm_tpu.models.variants import resolve_variant
from lbm_tpu.parallel import modes
from lbm_tpu.parallel import mesh as mesh_lib
from lbm_tpu.utils.invariants import calc_reynolds
from lbm_tpu.utils.timing import PhaseTimer


@dataclasses.dataclass
class RunConfig:
    variant: str = "auto"
    num_devices: int | None = None  # sharded variants: mesh size (None = all)
    # Halo age for async variants / chunk length for chunked mode.
    # None = per-variant default (async: 1, async-k: 2, chunked: 2).
    staleness: int | None = None
    num_steps: int | None = None  # override params.max_iters
    frame_interval: int | None = None  # capture |u| every k steps (None = off)
    backend: str | None = None  # force "jnp"/"pallas" per-step compute
    # State representation in device memory: "f32" (exact) or "i16" (int16
    # fixed-point deviations, ops/quant.py — half the memory traffic,
    # quantized after every step).
    storage: str = "f32"
    # Donate the initial state buffer to the scan.  Off by default: it saves
    # only the init buffer (scan double-buffers internally) and costs the
    # warm-up execution below.
    donate: bool = False
    debug: bool = False  # capture per-step total density (DEBUG analog,
    # SerialCode/d2q9-bgk.c:175-179); forces the per-step scan path
    checkpoint_every: int | None = None  # save state every N steps
    checkpoint_dir: str = "checkpoints"
    resume_from: str | None = None  # path of a checkpoint .npz to resume
    profile_dir: str | None = None  # capture a jax profiler trace of compute
    # Compile-latency control: execute long runs as repeated fixed-length
    # compiled segments instead of one num_steps-length executable, so the
    # compiled artifact is independent of --steps and the persistent
    # compilation cache hits across runs/scenes of the same grid.  None =
    # auto (segment when num_steps > _SEGMENT_STEPS); 0 = always one
    # executable; N>0 = explicit segment length.
    segment_steps: int | None = None
    # Warm each compiled executable with one discarded execution inside the
    # init bracket: the first dispatch of a freshly compiled program pays a
    # one-time load, which belongs to init like compile does — the
    # reference's binary is fully loaded before its timed loop starts.
    # Skipped for donating runs (the discarded execution would consume the
    # input buffers).
    warmup: bool = True
    # Run the block kernel in the Pallas interpreter (tests on a host
    # without a GPU; never chosen by platform).
    interpret: bool = False


@dataclasses.dataclass
class RunResult:
    f: np.ndarray  # (9, ny, nx) final distributions
    av_vels: np.ndarray  # (steps,) float32
    reynolds: float
    timer: PhaseTimer
    variant: str
    frames: np.ndarray | None = None  # (n_frames, ny, nx) |u| snapshots
    frame_steps: np.ndarray | None = None
    # Steps actually advanced by this run's compute phase (< len(av_vels)
    # when resuming from a checkpoint — the prefix was computed earlier).
    steps_computed: int | None = None

    @property
    def mlups(self) -> float:
        """Million lattice-cell updates per second of the compute phase."""
        cells = self.f.shape[1] * self.f.shape[2]
        steps = (
            self.steps_computed
            if self.steps_computed is not None
            else len(self.av_vels)
        )
        secs = self.timer.elapsed.get("compute", 0.0)
        return cells * steps / secs / 1e6 if secs > 0 else float("nan")


def _pick_variant(scene: Scene, config: RunConfig) -> str:
    variant = resolve_variant(config.variant)
    if variant != "auto":
        return variant
    n_dev = (
        config.num_devices
        if config.num_devices is not None
        else jax.device_count()
    )
    params = scene.params
    if n_dev > 1:
        # Multi-device auto: use the mesh — the reference's default IS the
        # parallel binary (MPI/d2q9-bgk.c:130-331).  The exact
        # communication-avoiding mode wherever it maps: bitwise-equal to
        # sync with one K-deep exchange per K steps instead of one per
        # step.  Where it cannot map (open seams, shards under K rows) the
        # stale-fraction model (1.6% stale rows -> ~0.15% deviation, 3% ->
        # ~0.5%) picks the latency-hiding async discipline when its
        # deviation stays comfortably inside the reference's 1% contract,
        # else the bitwise-exact comm/compute-overlap discipline.
        ca_stal = (
            config.staleness
            if config.staleness is not None
            else modes.STALENESS_DEFAULTS["ca"]
        )
        if modes.ca_supported(scene.obstacles, n_dev, ca_stal):
            return "ca"
        stale_fraction = 2.0 * n_dev / params.ny
        return "async" if stale_fraction <= 0.03 else "overlap"
    return modes.auto_backend(jax.default_backend())


def build_program(
    scene: Scene,
    config: RunConfig,
    f0: np.ndarray | None = None,
    build_init: bool = True,
) -> modes.StepProgram:
    """``build_init=False`` skips constructing the initial distribution
    state (``program.init_state`` is None) — for auxiliary step-only
    programs (sync tails / frame micro-steps) that are always lowered
    against the main program's live state.  Sharded bare-f modes only."""
    variant = _pick_variant(scene, config)
    params, obst = scene.params, scene.obstacles
    if variant in ("jnp", "pallas"):
        return modes.build_single_program(
            params, obst, f0=f0, backend=config.backend or variant,
            storage=config.storage, interpret=config.interpret,
        )
    if variant in ("sync", "overlap", "async", "async-k", "chunked", "ca"):
        mesh = mesh_lib.make_row_mesh(config.num_devices)
        mode = {"async-k": "async"}.get(variant, variant)
        defaults = modes.STALENESS_DEFAULTS
        if config.staleness is not None and variant in defaults:
            staleness = config.staleness
        elif variant in defaults:
            staleness = defaults[variant]
        else:
            staleness = 1
        return modes.build_sharded_program(
            params,
            obst,
            mesh,
            mode=mode,
            staleness=staleness,
            f0=f0,
            backend=config.backend,
            storage=config.storage,
            build_init=build_init,
            interpret=config.interpret,
        )
    raise ValueError(f"variant {variant!r} has no program builder")


class _HoistedCompiled:
    """Callable shim over a compiled hoisted program: ``call(state)``."""

    def __init__(self, compiled, consts):
        self._compiled = compiled
        self._consts = consts

    def __call__(self, state):
        return self._compiled(self._consts, *jax.tree.leaves(state))


class _HoistedLowered:
    def __init__(self, lowered, consts):
        self._lowered = lowered
        self._consts = consts

    def compile(self):
        return _HoistedCompiled(self._lowered.compile(), self._consts)


class _HoistedJit:
    """jit-like wrapper of ``run(state)`` whose closed-over array constants
    (obstacle masks and slabs) are hoisted out of the traced program and
    passed as runtime arguments instead of being embedded in the lowered
    module.

    The step factories bake geometry into jnp constants at build time;
    under plain ``jax.jit`` those constants ship inside the HLO, so
    executables and persistent-cache entries would be per-*geometry* even
    when the shapes match, and an 8192² obstacle mask would be a 64 MB
    constant in the module.  Hoisting keeps modules geometry-independent.
    The op sequence is unchanged — results are bitwise-identical to the
    embedded path (tests/test_hoist.py)."""

    def __init__(self, run, donate: bool):
        self._run = run
        self._donate = donate
        self._built = None  # (jrun, consts)

    def _build(self, state):
        leaves, treedef = jax.tree.flatten(state)
        specs = [jax.ShapeDtypeStruct(jnp.shape(l), l.dtype) for l in leaves]
        run = self._run

        def flat(*ls):
            return run(jax.tree.unflatten(treedef, list(ls)))

        closed, out_shape = jax.make_jaxpr(flat, return_shape=True)(*specs)
        out_tree = jax.tree.structure(out_shape)
        jaxpr, consts = closed.jaxpr, list(closed.consts)

        def conv(consts, *ls):
            outs = jax.core.eval_jaxpr(jaxpr, consts, *ls)
            return jax.tree.unflatten(out_tree, outs)

        donate = tuple(range(1, 1 + len(leaves))) if self._donate else ()
        self._built = (jax.jit(conv, donate_argnums=donate), consts)
        return self._built

    def lower(self, state):
        jrun, consts = self._built or self._build(state)
        return _HoistedLowered(
            jrun.lower(consts, *jax.tree.leaves(state)), consts
        )

    def __call__(self, state):
        jrun, consts = self._built or self._build(state)
        return jrun(consts, *jax.tree.leaves(state))


def _make_scan(
    program: modes.StepProgram,
    num_steps: int,
    frame_interval: int | None,
    debug: bool = False,
    donate: bool = False,
    tail_step=None,
):
    """Compile the whole timestep loop into one on-device scan.

    ``tail_step``: a single-step (sync-discipline) step function over the
    same state layout, used by the frame path to advance step counts that
    are not whole multiples of a multi-step program's chunk (ca)."""
    step = program.step
    spc = program.steps_per_call

    if debug and spc > 1 and program.chunk_inner_step is not None:
        # Chunked debug: per-step observables come from the chunk's
        # primitives (one frozen-ghost step / one exchange — composing
        # bitwise to the whole-chunk step), so the schedule is unchanged
        # and densities are sampled after every single step.  Remainder
        # steps exchange before every inner (fresh ghosts = the sync
        # discipline), matching the plain run's exact sync tail.
        if frame_interval is not None:
            raise ValueError("frames and --debug cannot be combined")
        inner, exch = program.chunk_inner_step, program.chunk_exchange
        n_chunks, rem_dbg = divmod(num_steps, spc)

        def _dens(state):
            return jnp.sum(program.f_of(state), dtype=jnp.float32)

        def dbg_chunk(state, _):
            ts, ds = [], []
            for _j in range(spc):
                state, tu = inner(state)
                ts.append(tu)
                ds.append(_dens(state))
            state = exch(state)
            return state, (jnp.stack(ts), jnp.stack(ds))

        def run(state):
            parts_t, parts_d = [], []
            if n_chunks:
                state, (t, d) = lax.scan(
                    dbg_chunk, state, None, length=n_chunks
                )
                parts_t.append(t.reshape(-1))
                parts_d.append(d.reshape(-1))
            for _j in range(rem_dbg):
                state = exch(state)
                state, tu = inner(state)
                parts_t.append(jnp.reshape(tu, (1,)))
                parts_d.append(jnp.reshape(_dens(state), (1,)))

            def cat(ps):
                return ps[0] if len(ps) == 1 else jnp.concatenate(ps)

            return state, (cat(parts_t), cat(parts_d)), None

        return _HoistedJit(run, donate)

    if debug:
        # Per-step observables: tot_u plus the total-density invariant.
        base_step = step

        def dbg_step(state):
            state, tot_u = base_step(state)
            dens = jnp.sum(program.f_of(state), dtype=jnp.float32)
            return state, (tot_u, dens)

        step = dbg_step

    if spc > 1:
        if debug:
            raise ValueError(
                f"debug tracing is not supported with {program.variant} "
                f"({spc} steps per call and no per-step decomposition); "
                "use the sync/overlap/async variants instead"
            )
        if frame_interval is not None and tail_step is None:
            if frame_interval % spc:
                raise ValueError(
                    f"frame capture with {program.variant} requires "
                    f"--frame-interval to be a multiple of the {spc}-step "
                    "chunk (capture segments must all start at the same "
                    "in-chunk phase)"
                )
        if frame_interval is None and num_steps % spc:
            # run_simulation splits off a sync tail before calling here; a
            # non-multiple reaching this point is an internal error.
            raise ValueError(
                f"{program.variant} advances {spc} steps per exchange; the "
                f"step count {num_steps} must be a multiple of it"
            )

    if frame_interval is None:

        def body(state, _):
            state, tot_u = step(state)
            return state, tot_u

        def run(state):
            state, tot_us = lax.scan(
                body, state, None, length=num_steps // spc, unroll=_SCAN_UNROLL
            )
            # Chunked programs emit (outer, spc); flatten to per-step order.
            if spc > 1:
                tot_us = jax.tree.map(lambda t: t.reshape(-1, *t.shape[2:]), tot_us)
            return state, tot_us, None

    else:
        n_frames = math.ceil(num_steps / frame_interval)
        interval = frame_interval

        def _frames0():
            # Padded (shard-divisible) extents: the frames buffer shares the
            # grid's row sharding, so it must use the internal shape; frames
            # are cropped back to the user grid at collate.
            ny, nx = program.global_shape
            frames0 = jnp.zeros((n_frames, ny, nx), dtype=jnp.float32)
            if program.mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P

                frames0 = jax.device_put(
                    frames0, NamedSharding(program.mesh, P(None, mesh_lib.ROWS, None))
                )
            return frames0

        if debug:
            # Legacy per-step body: debug observables are tuples that the
            # segmented fast structure below does not thread.
            def body(carry, tt):
                state, frames = carry
                state, tot_u = step(state)
                frame = program.u_mag(state)
                take = (tt % interval) == 0
                idx = tt // interval
                frames = lax.cond(
                    take,
                    lambda fr: lax.dynamic_update_slice(fr, frame[None], (idx, 0, 0)),
                    lambda fr: fr,
                    frames,
                )
                return (state, frames), tot_u

            def run(state):
                (state, frames), tot_us = lax.scan(
                    body, (state, _frames0()), jnp.arange(num_steps)
                )
                return state, tot_us, frames

            return _HoistedJit(run, donate)

        # Segmented frame capture: the run executes as inter-frame segments
        # of the program's own advance (the per-call step under an inner
        # scan) with |u| captured once per segment into a device buffer.  All inside
        # ONE jit, so the timed loop pays one u_mag + one buffer write per
        # frame instead of per step.  Capture points match the per-step path
        # exactly: frame k is the state after k*interval + 1 steps.  The
        # reference design point: zero-cost capture inside the fastest
        # variant (MPI_Testall_OptimizedVersion/d2q9-bgk.c:1093-1273).
        chunk_inner = program.chunk_inner_step
        chunk_exch = program.chunk_exchange
        # Chunked programs advance through their own primitives (one
        # frozen-ghost step / one ghost exchange): capture points land
        # mid-chunk without changing the schedule — the chunk's inner python
        # loop is merely split across jit ops.  interval % spc == 0
        # (validated above) keeps every whole-bulk segment at in-chunk phase
        # 1, so one compiled segment body serves them all.  Steps at or past
        # ``bulk_start`` (the plain run's exact-sync-tail region) exchange
        # before every inner — fresh ghosts, the sync discipline — so the
        # frames run stays bitwise-equal to the no-frames run at ANY step
        # count, not only multiples of the chunk.
        use_chunk_parts = spc > 1 and tail_step is None and chunk_inner is not None
        bulk_start = num_steps - (num_steps % spc) if use_chunk_parts else num_steps

        def make_adv(n, start=0):
            """state -> (state, (n,) per-step tot_us), advancing n steps
            (``start``: global step position at entry — chunked programs
            derive the in-chunk phase and the sync-tail boundary from it)."""
            if use_chunk_parts:

                def adv(state):
                    parts = []
                    pos, end = start, start + n
                    while pos < end:
                        if pos >= bulk_start:
                            # Sync-tail region: fresh ghosts every step.
                            state = chunk_exch(state)
                            state, tu = chunk_inner(state)
                            parts.append(jnp.reshape(tu, (1,)))
                            pos += 1
                            continue
                        t = min(spc - pos % spc, end - pos, bulk_start - pos)
                        if t == 1:
                            state, tu = chunk_inner(state)
                            parts.append(jnp.reshape(tu, (1,)))
                        else:
                            state, tb = lax.scan(
                                lambda s, _: chunk_inner(s), state, None,
                                length=t,
                            )
                            parts.append(tb)
                        pos += t
                        if pos % spc == 0:
                            state = chunk_exch(state)
                    if not parts:
                        return state, jnp.zeros((0,), jnp.float32)
                    return state, (
                        parts[0] if len(parts) == 1 else jnp.concatenate(parts)
                    )

                return adv
            calls, odd = divmod(n, spc)

            def adv(state):
                parts = []
                if calls:
                    def body(s, _):
                        return step(s)

                    state2, tb = lax.scan(body, state, None, length=calls)
                    state = state2
                    parts.append(tb.reshape(-1) if spc > 1 else tb)
                for _ in range(odd):
                    # ca: odd amounts advance via the exact sync step over
                    # the same bare-f state (bitwise continuation).
                    state, t = tail_step(state)
                    parts.append(jnp.reshape(t, (1,)))
                if not parts:
                    return state, jnp.zeros((0,), jnp.float32)
                return state, (
                    parts[0] if len(parts) == 1 else jnp.concatenate(parts)
                )

            return adv

        # After the first 1-step advance every segment starts at in-chunk
        # phase 1 (interval % spc == 0 for chunked programs).  Mid segments
        # fully inside the bulk share one compiled body under lax.scan; the
        # (at most one) segment crossing ``bulk_start`` and the final
        # partial segment get their own advances at static positions.
        adv_first = make_adv(1)
        mid_starts = [1 + (k - 1) * interval for k in range(1, n_frames)]
        n_scan = sum(1 for s in mid_starts if s + interval <= bulk_start)
        adv_mid = make_adv(interval, start=1) if n_scan else None
        late_advs = [
            make_adv(interval, start=s) for s in mid_starts[n_scan:]
        ]
        tail_n = num_steps - 1 - (n_frames - 1) * interval
        adv_tail = (
            make_adv(tail_n, start=1 + (n_frames - 1) * interval)
            if tail_n > 0
            else None
        )

        def run(state):
            state, t0 = adv_first(state)
            frames = lax.dynamic_update_slice(
                _frames0(), program.u_mag(state)[None], (0, 0, 0)
            )
            parts = [t0]
            if adv_mid is not None:
                def body(carry, k):
                    st, fr = carry
                    st, tots = adv_mid(st)
                    fr = lax.dynamic_update_slice(
                        fr, program.u_mag(st)[None], (k, 0, 0)
                    )
                    return (st, fr), tots

                (state, frames), t_mid = lax.scan(
                    body, (state, frames), jnp.arange(1, n_scan + 1)
                )
                parts.append(t_mid.reshape(-1))
            for j, adv in enumerate(late_advs):
                state, tots = adv(state)
                frames = lax.dynamic_update_slice(
                    frames, program.u_mag(state)[None], (n_scan + 1 + j, 0, 0)
                )
                parts.append(tots)
            if adv_tail is not None:
                state, t_tail = adv_tail(state)
                parts.append(t_tail)
            tot_us = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
            return state, tot_us, frames

    return _HoistedJit(run, donate)


# Steps per iteration of the scan's loop body.  With one step, the step's
# output cannot share the loop carry's buffer (every cell reads its
# neighbours), so XLA copies the whole state back into the carry after
# every step; two steps per iteration write the second step's output
# straight into the carry.  Measured on an H100 (PERF.md): the copy took
# half the step time of the block kernel at 1024² and 8192².
_SCAN_UNROLL = 2

# Default segment length for long runs.  4000 divides every reference
# scene's maxIters (20000/40000/80000), so full-length runs of all four
# grids share ONE compiled artifact per (grid, variant, backend) — and the
# persistent compilation cache makes recompiles across processes free.
# Segments are pure execution boundaries: scan(4000) ∘ scan(4000) performs
# the identical op sequence as scan(8000), so results are bitwise-equal to
# the single-executable path (tested).  Per-segment dispatch overhead is
# O(100 µs) against >= 100 ms of device work per segment.
_SEGMENT_STEPS = 4000


def _segment_lengths(
    num_steps: int, config: RunConfig, program: modes.StepProgram
) -> list[int] | None:
    """Split num_steps into fixed-size compiled segments, or None to run one
    num_steps-length executable (short runs / explicit --segment-steps 0)."""
    if config.frame_interval is not None or config.debug:
        return None  # frame/debug buffers are sized by the whole run
    seg = config.segment_steps
    if seg is None:
        seg = _SEGMENT_STEPS
    if seg <= 0 or num_steps <= seg:
        return None
    spc = program.steps_per_call
    if spc > 1:
        seg += (-seg) % spc  # keep each segment a whole number of chunks
    lengths = [seg] * (num_steps // seg)
    if num_steps % seg:
        lengths.append(num_steps % seg)
    return lengths


def _run_with_checkpoints(
    scene: Scene,
    config: RunConfig,
    program: modes.StepProgram,
    num_steps: int,
    start_step: int,
    av_prefix: np.ndarray,
    timer: PhaseTimer,
) -> RunResult:
    """Segmented execution with periodic state checkpoints.

    The scan is split into checkpoint_every-step segments; after each, the
    distributions and the av_vels series so far are saved to
    ``checkpoint_dir/ckpt_<step>.npz`` (loadable via RunConfig.resume_from).
    The reference has no checkpointing — this is a production-framework
    addition (SURVEY.md §5 notes its absence).
    """
    import os

    if config.frame_interval is not None or config.debug:
        raise ValueError("frames/debug are not supported with checkpointing")
    params = scene.params
    seg = config.checkpoint_every
    assert seg is not None and seg > 0
    if program.steps_per_call > 1 and seg % program.steps_per_call:
        raise ValueError("checkpoint_every must be a multiple of the chunk size")
    if program.steps_per_call > 1 and (num_steps - start_step) % program.steps_per_call:
        raise ValueError(
            f"checkpointed {program.variant} runs require the step count to "
            f"be a multiple of the {program.steps_per_call}-step chunk "
            "(drop --checkpoint-every to run the remainder as a sync tail)"
        )

    remaining = num_steps - start_step
    seg_lengths = [seg] * (remaining // seg)
    if remaining % seg:
        seg_lengths.append(remaining % seg)

    runs = {}
    for n in set(seg_lengths):
        runs[n] = _make_scan(program, n, None, False, donate=config.donate)
    # Compile (init phase cost).
    state = program.init_state
    compiled = {n: r.lower(state).compile() for n, r in runs.items()}
    timer.stop("init")

    os.makedirs(config.checkpoint_dir, exist_ok=True)
    av_parts = [av_prefix]
    step_count = start_step
    timer.start("compute")
    for n in seg_lengths:
        state, tot_us, _ = compiled[n](state)
        step_count += n
        # Checkpoint I/O happens between segments (outside would be dishonest
        # — it is a real cost of enabling checkpointing).
        av_parts.append(
            np.asarray(jax.device_get(tot_us), dtype=np.float32)
            / np.float32(program.tot_cells)
        )
        f_np = np.asarray(jax.device_get(program.f_of(state)), dtype=np.float32)
        np.savez_compressed(
            os.path.join(config.checkpoint_dir, f"ckpt_{step_count:08d}.npz"),
            f=f_np,
            step=step_count,
            av_vels=np.concatenate(av_parts),
        )
    timer.stop("compute")

    timer.start("collate")
    av_vels = np.concatenate(av_parts)
    f = np.asarray(jax.device_get(program.f_of(state)), dtype=np.float32)
    timer.stop("collate")
    reynolds = calc_reynolds(params, av_vels[-1]) if len(av_vels) else 0.0
    return RunResult(
        f=f,
        av_vels=av_vels,
        reynolds=reynolds,
        timer=timer,
        variant=program.variant,
        steps_computed=num_steps - start_step,
    )


def run_simulation(scene: Scene, config: RunConfig | None = None) -> RunResult:
    """Run a full simulation: init → compute (one on-device scan) → collate."""
    config = config or RunConfig()
    variant = _pick_variant(scene, config)
    params = scene.params
    num_steps = config.num_steps if config.num_steps is not None else params.max_iters
    timer = PhaseTimer()

    if variant == "serial":
        if config.resume_from or config.checkpoint_every:
            raise ValueError(
                "checkpoint/resume is not supported with the serial oracle "
                "variant; use the jnp or pallas variant"
            )
        if config.storage != "f32":
            raise ValueError(
                "storage 'i16' is not supported by the serial oracle variant"
            )
        with timer.section("init"):
            obst = scene.obstacles
        with timer.section("compute"):
            f, av_vels = oracle.run(params, obst, num_steps=num_steps)
        with timer.section("collate"):
            pass
        reynolds = calc_reynolds(params, av_vels[-1]) if num_steps else 0.0
        return RunResult(f=f, av_vels=av_vels, reynolds=reynolds, timer=timer, variant=variant)

    # Resume: restore distributions and the completed-step count from a
    # checkpoint (halo state of async modes is re-initialised fresh).
    f_resume = None
    start_step = 0
    av_prefix = np.zeros(0, dtype=np.float32)
    if config.resume_from:
        with np.load(config.resume_from) as ck:
            f_resume = np.asarray(ck["f"], dtype=np.float32)
            start_step = int(ck["step"])
            av_prefix = np.asarray(ck["av_vels"], dtype=np.float32)
        if f_resume.shape != (9, params.ny, params.nx):
            raise ValueError(
                f"checkpoint grid {f_resume.shape} does not match scene "
                f"(9, {params.ny}, {params.nx})"
            )
        if start_step >= num_steps:
            raise ValueError(
                f"checkpoint is at step {start_step}, beyond num_steps={num_steps}"
            )

    timer.start("init")
    # --debug with ca: ca performs the sync discipline's per-cell arithmetic
    # (tested bitwise, tests/test_ca.py), so per-step debug observables come
    # from the sync schedule — identical trajectory, no K-step carry in the
    # way.  Decided from the picked variant BEFORE building, so the ca
    # program is never constructed only to be discarded.
    picked = _pick_variant(scene, config)
    if config.debug and picked == "ca":
        import warnings

        ca_stal = (
            config.staleness
            if config.staleness is not None
            else modes.STALENESS_DEFAULTS["ca"]
        )
        ca_label = f"ca-{modes.ca_depth(ca_stal)}"
        warnings.warn(
            f"--debug decomposes {ca_label} into its bitwise-identical "
            "sync schedule (one exchange per step) for per-step observables",
            stacklevel=2,
        )
        dbg_cfg = dataclasses.replace(config, variant="sync", staleness=None)
        program = build_program(scene, dbg_cfg, f0=f_resume)
        program.variant = f"{ca_label}+debug-as-sync"
    else:
        program = build_program(scene, config, f0=f_resume)

    if config.checkpoint_every:
        return _run_with_checkpoints(
            scene, config, program, num_steps, start_step, av_prefix, timer
        )

    remaining = num_steps - start_step
    state0 = program.init_state

    # Multi-step programs (ca advances K steps per exchange, chunked k): a
    # step count that is not a multiple runs the remainder as an exact sync
    # tail.  Both programs' states carry the same sharded (and same-storage)
    # distribution array, and ca/chunked are seam-consistent at every
    # exchange boundary, so feeding the bulk-final f into the sync program
    # continues the run bitwise.
    spc = program.steps_per_call
    frames_on = config.frame_interval is not None
    tail_steps = (
        remaining % spc
        if spc > 1 and not frames_on and not config.debug
        else 0
    )
    bulk = remaining - tail_steps
    tail_program = None
    tail_exec = None
    tail_step_fn = None
    # Chunked programs expose their two primitives: the tail runs as
    # exchange-then-inner per step (fresh ghosts = the sync discipline),
    # sharing the exact ops the frames/debug decompositions use, so all
    # three paths stay bitwise-identical at any step count.
    if tail_steps and program.chunk_inner_step is not None:
        c_inner, c_exch = program.chunk_inner_step, program.chunk_exchange

        def _chunk_tail_run(state):
            def body(st, _):
                st = c_exch(st)
                st, tu = c_inner(st)
                return st, tu

            state, tots = lax.scan(body, state, None, length=tail_steps)
            return state, tots, None

        tail_exec = _HoistedJit(_chunk_tail_run, False).lower(state0).compile()
    # The sync auxiliary program serves two jobs: the post-bulk tail
    # executable for non-multiple step counts, and (frame capture on ca,
    # whose state is the same bare f) the in-jit single-step advance for
    # inter-frame segments that are not whole chunks.
    elif spc > 1 and (tail_steps or (frames_on and not isinstance(state0, tuple))):
        # Tuple-state multi-step programs (chunked) always expose chunk
        # primitives and take the branch above; only bare-f programs (ca)
        # reach the sync-program tail.  Keep that loud: the sync tail is
        # lowered against bare f and cannot unwrap a carry tuple.
        assert not isinstance(state0, tuple), (
            "multi-step program carries a state tuple but exposes no chunk "
            "primitives; the sync tail cannot advance it"
        )
        tail_cfg = dataclasses.replace(config, variant="sync", staleness=None)
        # The tail continues from the BULK's final state; its own init state
        # is never executed — skip building it (a full-grid host allocation
        # + transfer, gigabytes at 8192²) and lower against the main
        # state's f leaf, which is the same layout/sharding by construction.
        tail_program = build_program(scene, tail_cfg, build_init=False)
        tail_step_fn = tail_program.step
        if tail_steps:
            tail_exec = (
                _make_scan(tail_program, tail_steps, None, False)
                .lower(state0)
                .compile()
            )

    seg_lengths = _segment_lengths(bulk, config, program) if bulk else []
    if seg_lengths is None:
        seg_lengths = [bulk]
    if seg_lengths:
        compiled = {
            n: _make_scan(
                program, n, config.frame_interval, config.debug,
                donate=config.donate, tail_step=tail_step_fn,
            ).lower(state0).compile()
            for n in sorted(set(seg_lengths))
        }
    else:
        compiled = {}
    if (
        config.warmup
        and not config.donate
        and jax.default_backend() != "cpu"  # no device program to load
    ):
        # One discarded execution per executable: the first dispatch of a
        # freshly compiled program pays a one-time load (RunConfig.warmup),
        # which belongs in the init bracket with the compile.  Donating
        # runs would consume state0 — skipped.  Capped at segment length:
        # frames/debug programs compile ONE whole-run executable, and for
        # long runs a full discarded execution would cost more device time
        # than the load it hides — those skip the warmup and amortize the
        # one-time load over the long run itself.
        warm_outs = [
            exe(state0)[1]
            for n, exe in compiled.items()
            if n <= max(_SEGMENT_STEPS, config.segment_steps or 0)
        ]
        if tail_exec is not None:
            warm_outs.append(tail_exec(state0)[1])
        jax.block_until_ready(warm_outs)
    timer.stop("init")

    def _execute():
        state, frames = state0, None
        tot_parts = []
        for n in seg_lengths:
            state, tot_us, frames = compiled[n](state)
            tot_parts.append(tot_us)
        if tail_exec is not None:
            # Every tail path advances the state shape it was lowered
            # against: the chunk-primitive tail carries the program's own
            # (f, ghosts) tuple, the sync tail carries ca's bare f.
            state, tot_us, _ = tail_exec(state)
            tot_parts.append(tot_us)
        # Dispatch is asynchronous: wait for the device before the compute
        # bracket closes.
        jax.block_until_ready((state, tot_parts, frames))
        return state, tot_parts, frames

    timer.start("compute")
    if config.profile_dir:
        # Device-level tracing (the reference's only tracing is wall-clock
        # phase brackets, SerialCode/d2q9-bgk.c:156-200; this captures the
        # full host and device timeline for TensorBoard/xprof/Perfetto).
        with jax.profiler.trace(config.profile_dir):
            state, tot_parts, frames = _execute()
    else:
        state, tot_parts, frames = _execute()
    timer.stop("compute")

    timer.start("collate")
    densities = None
    if config.debug and tot_parts:
        tot_us, densities = tot_parts[0]  # debug never segments
        densities = np.asarray(jax.device_get(densities), dtype=np.float32)
        tot_us = np.asarray(jax.device_get(tot_us), dtype=np.float32)
    elif tot_parts:
        tot_us = np.concatenate(
            [np.asarray(jax.device_get(t), dtype=np.float32) for t in tot_parts]
        )
    else:
        tot_us = np.zeros(0, dtype=np.float32)
    f_of = (
        tail_program.f_of
        if tail_exec is not None and tail_program is not None
        else program.f_of
    )
    f = np.asarray(jax.device_get(f_of(state)), dtype=np.float32)
    av_vels = tot_us / np.float32(program.tot_cells)
    if start_step:
        av_vels = np.concatenate([av_prefix, av_vels])
    frames_np = None
    frame_steps = None
    if frames is not None:
        frames_np = np.asarray(jax.device_get(frames), dtype=np.float32)
        # Drop padding rows/columns (buffer is allocated at padded extents).
        frames_np = frames_np[:, : params.ny, : params.nx]
        frame_steps = start_step + np.arange(frames_np.shape[0]) * config.frame_interval
    timer.stop("collate")

    if config.debug and densities is not None:
        # Reference DEBUG output, deferred out of the timed loop
        # (SerialCode/d2q9-bgk.c:175-179).
        for tt in range(start_step, num_steps):
            print(f"==timestep: {tt}==")
            print("av velocity: %.12E" % av_vels[tt])
            print("tot density: %.12E" % densities[tt - start_step])

    reynolds = calc_reynolds(params, av_vels[-1]) if num_steps else 0.0
    return RunResult(
        f=f,
        av_vels=av_vels,
        reynolds=reynolds,
        timer=timer,
        variant=program.variant
        + (f"+sync-tail{tail_steps}" if tail_steps else ""),
        frames=frames_np,
        frame_steps=frame_steps,
        steps_computed=num_steps - start_step,
    )
