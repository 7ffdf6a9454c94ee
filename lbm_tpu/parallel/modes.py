"""Step programs: the single-device step and the row-sharded disciplines.

The reference ladder implements one domain decomposition (1-D row bands with
one halo row per side) under three communication disciplines:

- **sync** — blocking bidirectional exchange before any compute
  (two MPI_Sendrecv per step, MPI/d2q9-bgk.c:224-231);
- **overlap** — post sends/receives, compute interior rows during transfer,
  wait, then compute the two halo-dependent boundary rows
  (MPI_Waitall/d2q9-bgk.c:217-266);
- **async / stale halos** — never wait: boundary rows compute with whatever
  halo data is present, in practice one step old
  (MPI_Testall_OptimizedVersion/d2q9-bgk.c:251-307).

Here the decomposition is a ``shard_map`` over a 1-D mesh and the exchange is
a pair of ``lax.ppermute`` ring shifts, which XLA hands to NCCL.  XLA SPMD is
bulk-synchronous, so the async discipline becomes *deterministic bounded
staleness*: the ppermute that delivers step t+1's halos is issued at step t
and overlaps the whole of step t's compute, and boundary rows consume halo
rows exactly one step (or k steps, ``async-k``) old.  This is a
better-behaved version of the reference's "whatever arrived" semantics with
the same accuracy contract (<1% deviation from sync, README.md:9-13).

Two modes go beyond the reference: ``chunked`` (k local steps per exchange,
stale ghosts) and ``ca`` (one K-deep exchange per K steps, then K exact
steps on a shrinking slab — bitwise-equal to sync on fields, with the same
per-step backend).

Every program computes with the XLA step (ops/fused_jnp.py) unless the
block kernel (ops/fused_pallas.py) is asked for; ``storage='i16'`` wraps
either in the int16 codec of ops/quant.py, quantizing after every step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from lbm_tpu.core import lattice
from lbm_tpu.ops import fused_jnp, quant
from lbm_tpu.params import LBMParams
from lbm_tpu.parallel import mesh as mesh_lib

ROWS = mesh_lib.ROWS

# Per-variant staleness defaults (halo age / chunk length / ca exchange
# depth), shared by the driver and the --plan introspection so they cannot
# drift.
STALENESS_DEFAULTS = {"async": 1, "async-k": 2, "chunked": 2, "ca": 4}

BACKENDS = ("jnp", "pallas")
STORAGES = ("f32", "i16")


def ca_depth(staleness: int) -> int:
    """Exchange depth of the ca mode for a --staleness value (min 2: a
    1-deep exchange is just sync)."""
    return max(2, staleness)


def auto_backend(platform: str) -> str:
    """Per-step compute the auto policy picks: the Triton block kernel on a
    GPU — it beat the XLA step end to end at every measured grid, f32 and
    i16 (PERF.md) — and the XLA step on any other platform (the kernel is
    written for the Triton route only)."""
    return "pallas" if platform == "gpu" else "jnp"


def _check_storage(storage: str) -> None:
    if storage not in STORAGES:
        raise ValueError(f"unknown storage {storage!r}; use 'f32' or 'i16'")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use 'jnp' or 'pallas'")


@dataclasses.dataclass
class StepProgram:
    """A runnable step program over (possibly sharded) global arrays."""

    init_state: Any  # pytree; leaves are device arrays
    step: Callable[[Any], tuple[Any, jax.Array]]  # state -> (state, tot_u)
    f_of: Callable[[Any], jax.Array]  # state -> (9, ny, nx) global
    u_mag: Callable[[Any], jax.Array]  # state -> (ny, nx) |u|, 0 on obstacles
    tot_cells: int
    mesh: Any | None
    variant: str
    # Timesteps advanced per step() call; >1 for the chunked and ca modes
    # (step then returns a (steps_per_call,) tot_u vector).
    steps_per_call: int = 1
    # Compute backend actually selected ("jnp" / "pallas").
    backend: str | None = None
    # Global grid extents of the *internal* (possibly seam-padded) state;
    # on-device buffers indexed like the grid (e.g. frame captures) must use
    # this shape so their sharding divides evenly.  f_of/u_mag still return
    # the unpadded user view.
    global_shape: tuple[int, int] | None = None
    # Chunked programs only: the chunk decomposed into its two primitives
    # so the driver's frame path can stop at mid-chunk capture points
    # without changing the schedule.  chunk_inner_step advances ONE step
    # with frozen ghosts (no exchange); chunk_exchange refreshes the ghosts
    # (and pad clones) exactly as the whole-chunk step() does after its k
    # inner steps.  step() == k x inner + exchange (tested).
    chunk_inner_step: Callable[[Any], tuple[Any, jax.Array]] | None = None
    chunk_exchange: Callable[[Any], Any] | None = None


def open_seam_pad(obstacles: np.ndarray, num_shards: int) -> int:
    """Rows of OPEN-seam padding a scene needs on this mesh (0 when ny
    divides the shard count, or when both seam rows are walls so blocked
    padding can be inserted without touching the flow).

    The single source of truth for the seam rule — build_sharded_program,
    ca_supported, and models/plan.py all derive from it so the --plan
    prediction cannot drift from the build."""
    pad = (-obstacles.shape[0]) % num_shards
    if not pad:
        return 0
    walled = bool(obstacles[0].all()) and bool(obstacles[-1].all())
    return 0 if walled else pad


def _u_mag_fn(obstacles: jax.Array) -> Callable[[jax.Array], jax.Array]:
    def u_mag(f: jax.Array) -> jax.Array:
        rho = jnp.sum(f, axis=0)
        u_x = ((f[1] + f[5] + f[8]) - (f[3] + f[6] + f[7])) / rho
        u_y = ((f[2] + f[5] + f[6]) - (f[4] + f[7] + f[8])) / rho
        speed = jnp.sqrt(u_x * u_x + u_y * u_y)
        return jnp.where(obstacles, jnp.float32(0.0), speed)

    return u_mag


def _codec(storage: str, density: float):
    """(dequantize, quantize) for a whole (9, ...) state."""
    if storage == "i16":
        return (
            lambda q: quant.dequantize(q, density),
            lambda f: quant.quantize(f, density),
        )
    ident = lambda x: x
    return ident, ident


def build_single_program(
    params: LBMParams,
    obstacles: np.ndarray,
    f0: np.ndarray | None = None,
    backend: str | None = None,
    storage: str = "f32",
    interpret: bool = False,
) -> StepProgram:
    """Single-device program (periodic full grid).

    ``backend``: ``'jnp'`` (the XLA-fused step) or ``'pallas'`` (the Triton
    block kernel; ``interpret=True`` runs it in the Pallas interpreter, for
    tests on a host without a GPU); None = :func:`auto_backend`.

    ``storage='i16'`` keeps the state as int16 fixed-point deviations
    (ops/quant.py): half the memory traffic, quantized after every step.
    """
    _check_storage(storage)
    backend = backend or auto_backend(jax.default_backend())
    _check_backend(backend)
    if f0 is None:
        # Device-side broadcast init: no multi-GB host upload at 8192².
        f0 = lattice.equilibrium_rest_device(params.density, params.ny, params.nx)
    obst = jnp.asarray(obstacles, dtype=bool)
    dens = float(params.density)
    deq, q = _codec(storage, dens)

    if backend == "pallas":
        from lbm_tpu.ops import fused_pallas

        step = fused_pallas.make_step(
            params, np.asarray(obstacles), storage=storage, interpret=interpret
        )
    else:

        def step(state):
            f, tot_u = fused_jnp.fused_step_single(deq(state), obst, params)
            return q(f), tot_u

    mag = _u_mag_fn(obst)
    return StepProgram(
        init_state=q(jnp.asarray(f0, dtype=jnp.float32)),
        step=step,
        f_of=deq,
        u_mag=lambda s: mag(deq(s)),
        tot_cells=int(obstacles.size - np.count_nonzero(obstacles)),
        mesh=None,
        variant=backend + ("-i16" if storage == "i16" else ""),
        global_shape=(params.ny, params.nx),
        backend=backend,
    )


def ca_supported(
    obstacles: np.ndarray,
    num_shards: int,
    staleness: int = STALENESS_DEFAULTS["ca"],
) -> bool:
    """Whether ca mode can map this scene over ``num_shards`` — mirrors the
    build_sharded_program gate exactly: no open seam, and shards of at least
    K rows (a K-deep exchange takes K rows from each neighbour).  Used by
    the driver's auto policy and by --plan's will-FAIL prediction."""
    ny = obstacles.shape[0]
    if open_seam_pad(obstacles, num_shards):
        return False
    nloc = (ny + (-ny) % num_shards) // num_shards
    return nloc >= ca_depth(staleness)


def _extended_obstacle_slabs(
    obstacles: np.ndarray, num_shards: int, depth: int = 1
) -> np.ndarray:
    """Per-shard obstacle slabs with ``depth`` (periodically wrapped) ghost
    rows on each side, shape (R, nloc+2*depth, nx).  Static, built once at
    init — the analog of the reference's per-rank obstacle scatter
    (MPI/d2q9-bgk.c:730-828), with ghost rows added because the fused step
    applies the driven-row injection to ghost rows too."""
    ny, _ = obstacles.shape
    nloc = ny // num_shards
    slabs = []
    for r in range(num_shards):
        rows = np.arange(r * nloc - depth, r * nloc + nloc + depth) % ny
        slabs.append(obstacles[rows])
    return np.stack(slabs)


def build_sharded_program(
    params: LBMParams,
    obstacles: np.ndarray,
    mesh,
    mode: str = "sync",
    staleness: int = 1,
    f0: np.ndarray | None = None,
    backend: str | None = None,
    storage: str = "f32",
    build_init: bool = True,
    interpret: bool = False,
) -> StepProgram:
    """Row-sharded step program over ``mesh`` in one of the disciplines.

    Args:
      mode: "sync", "overlap", "async", "chunked" or "ca".  "async" with
        staleness > 1 is the explicit halo-queue variant, the deterministic
        analog of the reference's old-halo bookkeeping
        (MPI_Testall_ComplexVersion/d2q9-bgk.c:271-346).  "chunked" goes
        beyond the reference: halos are exchanged every ``staleness`` steps
        and each shard advances that many steps between exchanges (ghost age
        grows 1..k within a chunk), amortizing collective latency k-fold.
        "ca" exchanges K = ca_depth(staleness) rows each way every K steps
        and recomputes the halo levels locally: exact, K-fold fewer
        collectives.
      staleness: halo age in steps for async mode (k >= 1); chunk length for
        chunked mode; exchange depth for ca.
      backend: "jnp" or "pallas" for the per-shard slab step (ca runs it
        once per level); None = :func:`auto_backend`.
      storage: "f32" or "i16" (int16 fixed-point deviation state,
        ops/quant.py).  i16 halves both the per-shard memory traffic and the
        halo-exchange bytes.
      build_init: False skips constructing the initial distribution state
        (``init_state`` is None; no host allocation or device transfer) —
        for auxiliary step-only programs the driver lowers against an
        existing live state.  Only the bare-f modes (sync/overlap/ca)
        support this; the ghost-carrying modes derive their carry from f0.
      interpret: run the block kernel in the Pallas interpreter (tests).
    """
    ny, nx = obstacles.shape
    num_shards = mesh.shape[ROWS]
    _check_storage(storage)
    backend = backend or auto_backend(jax.default_backend())
    _check_backend(backend)
    if mode not in ("sync", "overlap", "async", "chunked", "ca"):
        raise ValueError(f"unknown sharded mode {mode!r}")
    if staleness < 1:
        raise ValueError("staleness must be >= 1")
    ny_orig = ny
    pad_rows = (-ny) % num_shards
    open_pad = 0
    if pad_rows:
        # The reference spreads remainder rows across ranks
        # (MPI/d2q9-bgk.c:674-695); shard_map needs equal shards, so instead
        # we pad the last shard.  Two regimes:
        #
        # - *Walled seam* (the reference's closed-box scenes): blocked
        #   padding rows.  Exact with zero extra communication — an obstacle
        #   row's emissions toward a side are mirrors of the flux arriving
        #   from that side, so wall-to-wall exchanges never reach fluid.
        # - *Open seam*: pad rows are live CLONES of the global first rows
        #   (the periodic wrap images), refreshed after every step by one
        #   extra ppermute of pad_rows rows.  The last shard's top real row
        #   then pulls its upper neighbors from a local clone of row 0, and
        #   shard 0's lower ghost is specially sourced from the true last
        #   real row — so sync/overlap remain bitwise-exact on any ny/P.
        open_pad = open_seam_pad(obstacles, num_shards)
        obstacles = np.concatenate(
            [obstacles, np.ones((pad_rows, nx), dtype=bool)], axis=0
        )
        if f0 is not None:
            f0 = np.asarray(f0, dtype=np.float32)
            tail = (
                f0[:, :pad_rows, :]  # wrap clones
                if open_pad
                else lattice.equilibrium_rest(params.density, pad_rows, nx)
            )
            f0 = np.concatenate([f0, tail], axis=1)
        ny += pad_rows
    nloc = ny // num_shards
    if nloc < 2:
        raise ValueError(f"need at least 2 rows per shard, got {nloc}")
    if open_pad and open_pad > nloc - 1:
        raise ValueError(
            f"ny={ny_orig} over {num_shards} shards needs {open_pad} "
            f"open-seam padding rows but shards have only {nloc} rows; "
            "choose fewer devices"
        )
    K_ca = ca_depth(staleness)
    if mode == "ca":
        if open_pad:
            raise ValueError(
                "ca mode does not support open-seam row padding; use a "
                "shard count that divides ny, or the sync/overlap variants"
            )
        if nloc < K_ca:
            raise ValueError(
                f"ca mode exchanges K={K_ca} rows each way but shards have "
                f"only {nloc} rows; use a smaller --staleness, fewer "
                "devices, or sync/overlap"
            )

    if f0 is None:
        f0 = lattice.equilibrium_rest(params.density, ny, nx) if build_init else None
    if not build_init and mode not in ("sync", "overlap", "ca"):
        raise ValueError(
            f"build_init=False requires a bare-f mode, got {mode!r} "
            "(ghost-carrying modes derive their carry from the init state)"
        )
    tot_cells = int(obstacles.size - np.count_nonzero(obstacles))
    fwd, bwd = mesh_lib.ring_perms(num_shards)
    dens = float(params.density)
    deq, q = _codec(storage, dens)

    f_sharding = mesh_lib.row_sharding(mesh)
    depth = K_ca if mode == "ca" else 1
    slabs_host = _extended_obstacle_slabs(obstacles, num_shards, depth)
    if backend == "pallas":
        from lbm_tpu.ops import fused_pallas

        slabs_host = fused_pallas.obstacle_codes(slabs_host)
    if jax.process_count() > 1:
        # Multi-controller: jitted functions may not close over arrays that
        # span non-addressable devices.  Keep the static obstacle data as
        # host constants; GSPMD shards them per the shard_map in_specs.
        obst_global = np.asarray(obstacles)
        obst_slabs = np.asarray(slabs_host)
    else:
        obst_global = jax.device_put(
            jnp.asarray(obstacles, dtype=bool), mesh_lib.mask_sharding(mesh)
        )
        obst_slabs = jax.device_put(
            jnp.asarray(slabs_host), NamedSharding(mesh, P(ROWS, None, None))
        )
    f_init = None
    if f0 is not None:
        f_init = q(jnp.asarray(f0, dtype=jnp.float32))
        f_init = jax.device_put(f_init, f_sharding)

    if backend == "pallas":
        from lbm_tpu.ops import fused_pallas

        # The overlap discipline and the ca levels compute sub-slabs of
        # different heights; build (and cache) one kernel per shape.
        _slab_steps: dict[tuple, Any] = {}

        def local_slab_step(slab, obst_slab, row_offset, tot_rows=None):
            key = (slab.shape[1] - 2, tot_rows)
            if key not in _slab_steps:
                _slab_steps[key] = fused_pallas.make_slab_step(
                    params, key[0], nx, ny, storage=storage,
                    interpret=interpret, tot_rows=tot_rows,
                )
            return _slab_steps[key](slab, obst_slab, row_offset)

    else:

        def local_slab_step(slab, obst_slab, row_offset, tot_rows=None):
            """(9, n+2, nx) ghosted slab -> ((9, n, nx), tot_u)."""
            new_f, tot_u = fused_jnp.fused_step_slab(
                deq(slab), obst_slab, params, row_offset, ny_global=ny,
                tot_rows=tot_rows,
            )
            return q(new_f), tot_u

    def exchange(f_local):
        """Ring halo exchange: returns (ghost row below, ghost row above) —
        the ppermute analog of the reference's paired Sendrecv
        (MPI/d2q9-bgk.c:224-231).

        Open-seam padding: the last shard's true last real row sits above
        its pad clones, so it sends that row (not its final slab row) as the
        lower ghost for shard 0."""
        if open_pad:
            is_last = lax.axis_index(ROWS) == num_shards - 1
            send_lo = jnp.where(
                is_last,
                f_local[:, nloc - open_pad - 1 : nloc - open_pad, :],
                f_local[:, -1:, :],
            )
        else:
            send_lo = f_local[:, -1:, :]
        ghost_lo = lax.ppermute(send_lo, ROWS, fwd)
        ghost_hi = lax.ppermute(f_local[:, :1, :], ROWS, bwd)
        return ghost_lo, ghost_hi

    def refresh_pads(new_f):
        """Refresh padding clones after a step.

        Open-seam rows: overwrite the last shard's pad rows with fresh clones
        of the global first rows (the periodic wrap images) — one ppermute of
        open_pad rows.  Identity when unpadded."""
        if open_pad:
            recv = lax.ppermute(new_f[:, :open_pad, :], ROWS, bwd)
            is_last = lax.axis_index(ROWS) == num_shards - 1
            refreshed = jnp.concatenate(
                [new_f[:, : nloc - open_pad, :], recv], axis=1
            )
            new_f = jnp.where(is_last, refreshed, new_f)
        return new_f

    def shard_row_offset():
        return lax.axis_index(ROWS) * nloc

    # --- the per-shard step disciplines -------------------------------------

    def step_sync(f_local, obst_slab):
        ghost_lo, ghost_hi = exchange(f_local)
        # Barrier: all data (including halos) must be in place before any
        # compute starts — the blocking-Sendrecv discipline.
        f_local, ghost_lo, ghost_hi = lax.optimization_barrier(
            (f_local, ghost_lo, ghost_hi)
        )
        slab = jnp.concatenate([ghost_lo, f_local, ghost_hi], axis=1)
        new_f, tot_u = local_slab_step(slab, obst_slab, shard_row_offset())
        return refresh_pads(new_f), tot_u

    def step_overlap(f_local, obst_slab):
        off = shard_row_offset()
        ghost_lo, ghost_hi = exchange(f_local)
        bot_slab = jnp.concatenate([ghost_lo, f_local[:, :2]], axis=1)
        bot, tot_u_bot = local_slab_step(bot_slab, obst_slab[:3], off)
        top_slab = jnp.concatenate([f_local[:, -2:], ghost_hi], axis=1)
        top, tot_u_top = local_slab_step(top_slab, obst_slab[-3:], off + nloc - 1)
        if nloc > 2:
            # Interior rows 1..nloc-2 depend only on local data, so XLA can
            # compute them while the ppermutes fly — the Isend/Irecv +
            # interior-compute + Waitall discipline
            # (MPI_Waitall/d2q9-bgk.c:234-253).
            interior, tot_u_int = local_slab_step(f_local, obst_slab[1:-1], off + 1)
            new_f = jnp.concatenate([bot, interior, top], axis=1)
        else:
            # Two-row shards have no interior (the reference hits the same
            # degenerate split when rows-per-rank is minimal).
            tot_u_int = jnp.float32(0.0)
            new_f = jnp.concatenate([bot, top], axis=1)
        return refresh_pads(new_f), (tot_u_int + tot_u_bot) + tot_u_top

    def step_async(carry, obst_slab):
        # carry ghosts are one step old; the exchange issued here delivers
        # ghosts for the NEXT step, so it overlaps this entire step's compute
        # — the deterministic analog of the single ignored MPI_Testall poll
        # (MPI_Testall_OptimizedVersion/d2q9-bgk.c:279-290).
        f_local, ghost_lo, ghost_hi = carry
        new_ghosts = exchange(f_local)
        slab = jnp.concatenate([ghost_lo, f_local, ghost_hi], axis=1)
        new_f, tot_u = local_slab_step(slab, obst_slab, shard_row_offset())
        return (refresh_pads(new_f), *new_ghosts), tot_u

    def step_async_k(carry, obst_slab):
        # Explicit halo queue: ghosts consumed are k steps old.  The
        # deterministic counterpart of the reference's old-halo buffers
        # (MPI_Testall_ComplexVersion/d2q9-bgk.c:185-187, 271-346).
        f_local, q_lo, q_hi = carry
        new_lo, new_hi = exchange(f_local)
        ghost_lo, ghost_hi = q_lo[0], q_hi[0]
        q_lo = jnp.concatenate([q_lo[1:], new_lo[None]], axis=0)
        q_hi = jnp.concatenate([q_hi[1:], new_hi[None]], axis=0)
        slab = jnp.concatenate([ghost_lo, f_local, ghost_hi], axis=1)
        new_f, tot_u = local_slab_step(slab, obst_slab, shard_row_offset())
        return (refresh_pads(new_f), q_lo, q_hi), tot_u

    def step_ca(f_local, obst_ext):
        # Communication-avoiding EXACT discipline (beyond the reference's
        # ladder): exchange the K raw boundary rows once, then advance K
        # steps on a slab that shrinks by one row per side per step — the
        # halo rows' evolution is recomputed locally.  The standard
        # CA-stencil schedule: the same per-cell arithmetic as sync, one
        # collective per K steps.
        ghost_lo = lax.ppermute(f_local[:, -K_ca:, :], ROWS, fwd)
        ghost_hi = lax.ppermute(f_local[:, :K_ca, :], ROWS, bwd)
        f_local, ghost_lo, ghost_hi = lax.optimization_barrier(
            (f_local, ghost_lo, ghost_hi)
        )
        ext = jnp.concatenate([ghost_lo, f_local, ghost_hi], axis=1)
        off = shard_row_offset()
        tots = []
        for s in range(K_ca):
            # ext holds nloc + 2(K-s) rows, the first at global row
            # off-(K-s); this level's output drops one row per side.
            halo = K_ca - s - 1
            n_out = nloc + 2 * halo
            ext, tot_u = local_slab_step(
                ext, obst_ext[s : s + n_out + 2], off - halo,
                tot_rows=(halo, halo + nloc),
            )
            tots.append(tot_u)
        return ext, jnp.stack(tots)

    def step_chunked(carry, obst_slab):
        # Beyond the reference: advance `staleness` steps per halo exchange,
        # with ghost rows frozen for the chunk (age 1..k).  One ppermute pair
        # per k steps — collective latency amortized k-fold, and the inner
        # steps are a pure local loop.
        f_local, ghost_lo, ghost_hi = carry
        off = shard_row_offset()
        # Open-seam pads must stay valid within the chunk: freeze them at
        # their chunk-start clone values (consistent with the frozen
        # ghosts) — evolving them would feed garbage, not stale data, to
        # the top real row's pulls.
        if open_pad:
            is_last = lax.axis_index(ROWS) == num_shards - 1
            pads0 = f_local[:, nloc - open_pad :, :]
        tot_list = []
        for _ in range(staleness):
            slab = jnp.concatenate([ghost_lo, f_local, ghost_hi], axis=1)
            f_local, tot_u = local_slab_step(slab, obst_slab, off)
            if open_pad:
                frozen = jnp.concatenate(
                    [f_local[:, : nloc - open_pad, :], pads0], axis=1
                )
                f_local = jnp.where(is_last, frozen, f_local)
            tot_list.append(tot_u)
        tots = jnp.stack(tot_list)
        new_ghosts = exchange(f_local)
        return (refresh_pads(f_local), *new_ghosts), tots

    # --- wrap in shard_map over global arrays -------------------------------

    f_spec = P(None, ROWS, None)
    slab_spec = P(ROWS, None, None)

    def spmd(per_shard, state_specs):
        """shard_map a per-shard step into a global-state step; the obstacle
        slab rides along and tot_u is psum-reduced (the MPI_Reduce analog,
        MPI/d2q9-bgk.c:298-309)."""

        def shard_fn(state, obst_slab):
            new_state, tot_u = per_shard(state, obst_slab[0])
            return new_state, lax.psum(tot_u, ROWS)

        mapped = jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(state_specs, slab_spec),
            out_specs=(state_specs, P()),
            check_vma=False,
        )

        def step(state):
            return mapped(state, obst_slabs)

        return step

    # Per-shard ghost rows live as global arrays of shape (9, R, nx) sharded
    # over the middle axis, one row per shard, so they reuse f_spec.
    if mode in ("sync", "overlap", "ca"):
        step = spmd(
            {"sync": step_sync, "overlap": step_overlap, "ca": step_ca}[mode],
            f_spec,
        )
        init_state = f_init
        f_of = lambda s: s
    else:  # async / chunked
        # Accuracy scales with the stale-row fraction (2 rows per shard
        # interface) and with the halo age.  Measured against the reference
        # goldens: 1.6% stale rows -> ~0.15% av_vels deviation; ~6% -> ~1%.
        # Warn when the configuration leaves the reference's <1% contract
        # (README.md:9-13).
        # Chunked ghosts age 1..k (mean (k+1)/2); async-k ghosts are k old.
        age = (staleness + 1) / 2 if mode == "chunked" else staleness
        stale_fraction = 2.0 * num_shards / ny * age
        if stale_fraction > 0.05:
            import warnings

            warnings.warn(
                f"{mode} mode with {num_shards} shards over {ny} rows at halo "
                f"age {staleness} has an effective stale-row exposure of "
                f"{stale_fraction:.1%}; deviation from the synchronous "
                "solution may exceed 1%. Use fewer shards, a larger grid, a "
                "smaller staleness, or the sync/overlap variants.",
                stacklevel=2,
            )
        init_ghosts = jax.jit(
            jax.shard_map(
                exchange,
                mesh=mesh,
                in_specs=f_spec,
                out_specs=(f_spec, f_spec),
                check_vma=False,
            )
        )
        g_lo0, g_hi0 = init_ghosts(f_init)
        if mode == "chunked":
            step = spmd(step_chunked, (f_spec, f_spec, f_spec))
            init_state = (f_init, g_lo0, g_hi0)
        elif staleness == 1:
            step = spmd(step_async, (f_spec, f_spec, f_spec))
            init_state = (f_init, g_lo0, g_hi0)
        else:
            qspec = P(None, None, ROWS, None)
            q_lo0 = jnp.broadcast_to(g_lo0[None], (staleness,) + g_lo0.shape)
            q_hi0 = jnp.broadcast_to(g_hi0[None], (staleness,) + g_hi0.shape)
            q_lo0 = jax.device_put(q_lo0, NamedSharding(mesh, qspec))
            q_hi0 = jax.device_put(q_hi0, NamedSharding(mesh, qspec))
            step = spmd(step_async_k, (f_spec, qspec, qspec))
            init_state = (f_init, q_lo0, q_hi0)
        f_of = lambda s: s[0]

    mag_local = _u_mag_fn(obst_global)
    if storage == "i16":
        _raw_f_of = f_of

        def f_of(state):  # noqa: F811 — wraps the storage codec
            return deq(_raw_f_of(state))

    # Chunk primitives for the driver's frame path (see StepProgram): one
    # frozen-ghost step and one ghost exchange, composing bitwise to the
    # whole-chunk step().  Open-seam pads are frozen at chunk-start clone
    # values inside step_chunked — but they never change BETWEEN exchanges,
    # so each inner step's input pad rows already hold those values and a
    # stateless per-step decomposition reproduces the freeze exactly by
    # restoring its own input's pads after the step.
    chunk_inner_step = None
    chunk_exchange = None
    if mode == "chunked":

        def _chunk_inner_shard(carry, obst_slab):
            f_local, ghost_lo, ghost_hi = carry
            if open_pad:
                is_last = lax.axis_index(ROWS) == num_shards - 1
                pads0 = f_local[:, nloc - open_pad :, :]
            slab = jnp.concatenate([ghost_lo, f_local, ghost_hi], axis=1)
            new_f, tot_u = local_slab_step(slab, obst_slab, shard_row_offset())
            if open_pad:
                frozen = jnp.concatenate(
                    [new_f[:, : nloc - open_pad, :], pads0], axis=1
                )
                new_f = jnp.where(is_last, frozen, new_f)
            return (new_f, ghost_lo, ghost_hi), tot_u

        chunk_inner_step = spmd(_chunk_inner_shard, (f_spec, f_spec, f_spec))

        def _chunk_exch_shard(carry):
            f_local = carry[0]
            new_lo, new_hi = exchange(f_local)
            return (refresh_pads(f_local), new_lo, new_hi)

        chunk_exchange = jax.shard_map(
            _chunk_exch_shard,
            mesh=mesh,
            in_specs=((f_spec, f_spec, f_spec),),
            out_specs=(f_spec, f_spec, f_spec),
            check_vma=False,
        )

    f_of_padded = f_of

    if pad_rows:
        # External views (final state, frames) drop the padding rows.
        def f_of(state):  # noqa: F811 — deliberately shadows the padded view
            return f_of_padded(state)[:, :ny_orig, :]

        def u_mag(state):
            return mag_local(f_of_padded(state))[:ny_orig, :]

    else:

        def u_mag(state):
            return mag_local(f_of_padded(state))

    return StepProgram(
        init_state=init_state,
        step=step,
        f_of=f_of,
        u_mag=u_mag,
        tot_cells=tot_cells,
        mesh=mesh,
        variant=f"{mode}"
        + (
            # ca reports its *effective* exchange depth, not the raw
            # staleness knob (ca_depth(1)=2: --staleness 1 still runs a
            # 2-step schedule and the label must say so).
            f"-{K_ca}"
            if mode == "ca"
            else f"-{staleness}"
            if mode in ("async", "chunked") and staleness > 1
            else ""
        )
        + ("-i16" if storage == "i16" else ""),
        steps_per_call=(
            staleness if mode == "chunked"
            else K_ca if mode == "ca"
            else 1
        ),
        global_shape=(ny, nx),
        backend=backend,
        chunk_inner_step=chunk_inner_step,
        chunk_exchange=chunk_exchange,
    )
