"""Execution-plan introspection: what would `run` actually execute?

``lbm_tpu run ... --plan`` prints this and exits.  Every line is derived
from the SAME selection functions the driver uses (variant auto-policy,
``modes.ca_supported``, staleness defaults, checkpoint/segment layout), so
the description cannot drift from the real execution path.
"""

from __future__ import annotations

from lbm_tpu.io.scene import Scene

_BACKEND_DESC = {
    "jnp": "XLA-fused step (ops/fused_jnp.py)",
    "pallas": "Triton block kernel (ops/fused_pallas.py)",
}
_STORAGE_DESC = {
    "f32": "",
    "i16": " with int16 state, quantized after every step (ops/quant.py)",
}


def describe_plan(scene: Scene, config) -> str:
    import jax

    from lbm_tpu.models import driver
    from lbm_tpu.parallel import modes

    params = scene.params
    ny, nx = params.ny, params.nx
    num_steps = (
        config.num_steps if config.num_steps is not None else params.max_iters
    )
    lines = []
    out = lines.append

    variant = driver._pick_variant(scene, config)
    out(f"grid: {ny}x{nx}  steps: {num_steps}  storage: {config.storage}")
    out(f"variant: {variant}"
        + ("  (auto-selected)" if config.variant == "auto" else ""))

    spc = 1
    if variant == "serial":
        out("path: host NumPy oracle (4-pass)")
    elif variant in ("jnp", "pallas"):
        backend = config.backend or variant
        out("path: " + _BACKEND_DESC[backend] + _STORAGE_DESC[config.storage]
            + ", lax.scan on device")
    else:  # sharded
        n_dev = config.num_devices or jax.device_count()
        nloc = -(-ny // n_dev)
        out(f"mesh: {n_dev}-device 'rows' ring  (~{nloc} rows/shard, "
            "ppermute halo exchange, psum reduction)")
        stal = (
            config.staleness
            if config.staleness is not None
            else modes.STALENESS_DEFAULTS.get(variant, 1)
        )
        K_ca = modes.ca_depth(stal)
        desc = {
            "sync": "blocking exchange every step (bitwise-exact)",
            "overlap": "interior compute overlaps exchange (bitwise-exact)",
            "async": f"stale halos, age {stal} (bounded staleness)",
            "async-k": f"explicit halo queue, age {stal}",
            "chunked": f"{stal} local steps per exchange (ghost age 1..{stal})",
            "ca": f"communication-avoiding: {K_ca}-deep exchange "
                  f"every {K_ca} steps (bitwise-exact)",
        }[variant]
        out(f"discipline: {desc}")
        if variant in ("async", "async-k", "chunked"):
            # The deterministic halo-age profile (SURVEY §4: per-step age
            # histograms are trivial here — age is static by construction).
            age = (stal + 1) / 2 if variant == "chunked" else stal
            frac = 2.0 * n_dev / ny * age
            out(f"halo ages: boundary rows (2/{nloc} per shard) at mean age "
                f"{age:g}, interior exact; stale-row exposure "
                f"{frac:.1%} -> expected av_vels deviation "
                f"{'<0.2%' if frac <= 0.016 else '<1%' if frac <= 0.05 else '>1% (driver warns)'}")
        backend = config.backend or modes.auto_backend(jax.default_backend())
        out("per-shard step: " + _BACKEND_DESC[backend]
            + _STORAGE_DESC[config.storage])
        if variant == "ca":
            # The SAME gate the build and the auto policy use
            # (modes.ca_supported) — no drift.
            pad_rows = (-ny) % n_dev
            if modes.open_seam_pad(scene.obstacles, n_dev):
                out("NOTE: this run will FAIL — ca does not support "
                    "open-seam row padding (ny not divisible by the mesh)")
            elif not modes.ca_supported(scene.obstacles, n_dev, stal):
                out(f"NOTE: this run will FAIL — ca exchanges {K_ca} rows "
                    f"each way but shards have "
                    f"{(ny + pad_rows) // n_dev} rows")
            else:
                out(f"ca: {K_ca} steps per exchange on a slab shrinking "
                    f"from {(ny + pad_rows) // n_dev}+2x{K_ca} rows")
        spc = K_ca if variant == "ca" else stal if variant == "chunked" else 1
        # Mirror the driver's debug handling of multi-step programs
        # (models/driver.py run_simulation + _make_scan).
        if config.debug and spc > 1 and variant == "ca":
            out("debug: per-step observables via the bitwise-identical "
                "sync schedule (one exchange per step)")
            spc = 1

    tail = num_steps % spc if spc > 1 else 0
    if tail and config.frame_interval is not None:
        # The driver absorbs the remainder into the capture scan: ca runs
        # sync micro-steps, chunked runs fresh-ghost primitive steps — both
        # bitwise-equal to the plain run's exact sync tail.
        out(f"tail: the last {tail} step(s) run as per-step sync steps "
            "inside the capture scan (bitwise continuation)")
        tail = 0
    elif tail and config.debug:
        # Chunked debug decomposes through the chunk primitives, remainder
        # included (exchange-then-inner = the sync discipline).
        out(f"tail: the last {tail} step(s) run as fresh-ghost per-step "
            "decomposition inside the debug scan")
        tail = 0
    if (
        config.frame_interval is not None
        and variant == "chunked"
        and spc > 1
        and config.frame_interval % spc
    ):
        out(f"NOTE: this run will FAIL — frame capture with chunked requires "
            f"--frame-interval to be a multiple of the {spc}-step chunk")
    if tail:
        out(f"tail: {variant} advances {spc} steps per exchange; the last "
            f"{tail} step(s) run as an exact sync tail (bitwise continuation)")

    if config.checkpoint_every:
        n_full, rem = divmod(num_steps, config.checkpoint_every)
        out(f"execution: checkpointed segments of {config.checkpoint_every} "
            f"steps ({n_full}" + (f" + one of {rem}" if rem else "")
            + f"), snapshots in {config.checkpoint_dir}/")
        if spc > 1 and config.checkpoint_every % spc:
            out(f"NOTE: this run will FAIL — checkpoint_every must be a "
                f"multiple of the {spc}-step chunk")
        if tail:
            out(f"NOTE: this run will FAIL — checkpointed {variant} runs "
                f"require the step count to be a multiple of the {spc}-step "
                "chunk")
        return "\n".join(lines)

    bulk = num_steps - tail
    seg = config.segment_steps
    seg = driver._SEGMENT_STEPS if seg is None else seg
    if seg > 0 and bulk > seg and not config.debug and config.frame_interval is None:
        seg += (-seg) % spc  # driver keeps segments whole numbers of chunks
        n_full, rem = divmod(bulk, seg)
        out(f"execution: {n_full} compiled segment(s) of {seg} steps"
            + (f" + one of {rem}" if rem else "")
            + "  (persistent compile cache applies)")
    else:
        out("execution: one compiled program for the whole run")
    return "\n".join(lines)
