"""minimap2_rs_tpu — a long-read mapping framework on JAX accelerators.

A from-scratch JAX/XLA/Pallas implementation of the minimap2-class mapping
pipeline (minimizer sketching -> reference index -> seeding/anchors ->
colinear chaining DP -> chain selection -> PAF output) with the same
capabilities as the reference Rust implementation (xuzhougeng/minimap2_rs),
re-designed for data-parallel accelerators (an NVIDIA GPU today):

- sketching and chaining run as vectorized XLA programs (the chain DP as
  a Pallas/Triton kernel on the GPU) over padded,
  masked batches (no pointer-chasing, no data-dependent shapes under jit);
- the minimizer index is a flat device-resident table probed with
  vectorized lookups (replacing the reference's per-bucket HashMaps,
  /root/reference/src/index.rs:31,74-109);
- scale-out is expressed with jax.sharding Mesh + shard_map: data-parallel
  read batches, an optionally hash-range-sharded index with all-to-all
  anchor exchange, and collectives for stats/merge;
- byte-level I/O (FASTA, .mmi interchange, PAF) lives on the host, with a
  native C++ runtime library and pure-NumPy fallbacks.

Subpackages
-----------
oracle   : bit-exact scalar/NumPy transcriptions of the reference's
           algorithmic contracts; the golden parity path and test oracles.
ops      : device kernels (sketch, index build/lookup, anchors, chain DP).
models   : end-to-end pipelines (Mapper, IndexBuilder).
parallel : mesh construction, sharded index, distributed mapping.
io       : FASTA / MMI / PAF host I/O.
runtime  : native C++ host runtime + ctypes bindings.
utils    : encodings, packing, sequence simulation.
"""

__version__ = "0.1.0"
