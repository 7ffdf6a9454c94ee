"""lbm_tpu — a D2Q9-BGK lattice-Boltzmann framework in JAX, run on GPUs.

A ground-up rebuild of the capability set of the reference MPI/OpenMP C codebase
(Xinran1205/LBM-Asynchronous): a D2Q9 BGK solver for lid-driven-cavity-style flows
that reads the same ``input_*.params`` / ``obstacles_*.dat`` scene files and emits
the same ``av_vels.dat`` / ``final_state.dat`` outputs, validated at <1% error
against the reference golden data.

Architecture:

- ``core``     lattice constants, equilibrium, and a NumPy serial oracle
               (ground truth; analog of reference SerialCode/d2q9-bgk.c).
- ``io``       scene parsing and output writing in the reference's exact text
               formats, with an optional native C++ fast path.
- ``ops``      the fused collide-stream step: the XLA-fused jnp step and a
               block kernel in Pallas through Triton (analog of the reference's
               fused ``fusion_more`` kernels, OpenMP/d2q9-bgk.c:260-498).
- ``parallel`` row-sharded multi-device execution over a ``jax.sharding.Mesh``
               with ppermute halo exchange: sync (MPI_Sendrecv analog), overlap
               (MPI_Isend+Waitall analog), deterministic bounded-staleness async
               (MPI_Testall stale-halo analog), chunked, and the exact
               communication-avoiding ca mode.
- ``models``   solver variants registry + the simulation driver (scan loop,
               phase timing, frame capture, output collation).
- ``tools``    result checker (check.py analog), visualization, animation.
- ``utils``    timers, invariants (total density, Reynolds number).
"""

from lbm_tpu.params import LBMParams

__version__ = "0.1.0"

__all__ = ["LBMParams", "__version__"]
