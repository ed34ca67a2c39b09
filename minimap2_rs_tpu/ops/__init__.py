"""Device kernels: the JAX/XLA/Pallas compute path.

Everything here runs under jit with static shapes, masked padding, and
32-bit arithmetic: 64-bit quantities (hashed keys, packed positions) are
carried as (hi, lo) uint32 pairs (ops.u64), so nothing needs
jax_enable_x64.
"""

from .u64 import U64Pair  # noqa: F401
