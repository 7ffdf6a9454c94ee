"""Solver-variant registry.

The reference is a ladder of six progressively more asynchronous variants of
one solver (README.md:30-75); this table is the JAX counterpart.  Each
variant names a step-construction strategy; the driver (models/driver.py)
wires it into the on-device scan loop.

| name       | reference analog                      | execution                          |
|------------|---------------------------------------|------------------------------------|
| serial     | SerialCode (4-pass, ground truth)     | host NumPy oracle                  |
| jnp        | OpenMP fused kernel (fusion_more)     | single device, XLA-fused jnp       |
| pallas     | OpenMP fused kernel, hand-tuned       | single device, Triton block kernel |
| sync       | MPI blocking Sendrecv halo exchange   | row-sharded mesh, barrier ppermute |
| overlap    | MPI_Isend/Irecv + Waitall overlap     | row-sharded, dataflow ppermute     |
| async      | MPI_Testall stale halos (headline)    | row-sharded, staleness-1 halos     |
| async-k    | MPI_Testall_ComplexVersion old-halo   | row-sharded, staleness-k queue     |
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class VariantSpec:
    name: str
    reference_analog: str
    sharded: bool
    description: str


VARIANTS: dict[str, VariantSpec] = {
    "serial": VariantSpec(
        "serial",
        "SerialCode/d2q9-bgk.c",
        False,
        "Host NumPy oracle; 4 separate passes per step. Ground truth.",
    ),
    "jnp": VariantSpec(
        "jnp",
        "OpenMP/d2q9-bgk.c (fusion_more)",
        False,
        "Single-device fused step in jnp; XLA fuses streaming into collision.",
    ),
    "pallas": VariantSpec(
        "pallas",
        "OpenMP/d2q9-bgk.c (fusion_more), hand-tuned",
        False,
        "Single-device fused block kernel (Pallas through Triton, GPU).",
    ),
    "sync": VariantSpec(
        "sync",
        "MPI/d2q9-bgk.c (blocking Sendrecv)",
        True,
        "Row-sharded; halo exchange completes before any compute (barrier).",
    ),
    "overlap": VariantSpec(
        "overlap",
        "MPI_Waitall/d2q9-bgk.c (Isend/Irecv + Waitall)",
        True,
        "Row-sharded; interior computes while halos are in flight.",
    ),
    "async": VariantSpec(
        "async",
        "MPI_Testall_OptimizedVersion/d2q9-bgk.c (stale halos)",
        True,
        "Row-sharded; boundary rows use halos one step old (deterministic "
        "bounded staleness), fully overlapping communication.",
    ),
    "async-k": VariantSpec(
        "async-k",
        "MPI_Testall_ComplexVersion/d2q9-bgk.c (explicit old-halo buffers)",
        True,
        "Row-sharded; explicit halo queue with configurable staleness k.",
    ),
    "chunked": VariantSpec(
        "chunked",
        "beyond the reference (stale-halo idea taken to chunked execution)",
        True,
        "Row-sharded; halos exchanged every k steps, k local steps between "
        "exchanges (ghost age 1..k) — collective latency amortized k-fold.",
    ),
    "ca": VariantSpec(
        "ca",
        "beyond the reference (communication-avoiding stencil schedule)",
        True,
        "Row-sharded; one K-deep raw halo exchange per K steps, boundary "
        "levels recomputed locally on a shrinking slab — results "
        "bitwise-equal to sync with collectives amortized K-fold.",
    ),
}

_ALIASES = {
    "openmp": "jnp",
    "fused": "jnp",
    "mpi": "sync",
    "waitall": "overlap",
    "semi-async": "overlap",
    "testall": "async",
    "stale": "async",
    "testall-complex": "async-k",
    "auto": "auto",
}


def resolve_variant(name: str) -> str:
    name = name.lower()
    name = _ALIASES.get(name, name)
    if name != "auto" and name not in VARIANTS:
        raise ValueError(
            f"unknown variant {name!r}; available: {sorted(VARIANTS)} "
            f"(aliases: {sorted(_ALIASES)})"
        )
    return name
