r"""Device compute: JAX programs and a CUDA kernel for the hot paths.

- :mod:`kaptive_tpu.ops.swg` — batched banded Smith-Waterman-Gotoh DP
  (protein identity + nucleotide extension), row-parallel formulation.
- :mod:`kaptive_tpu.ops.minimizer` — 2-bit k-mer hashing + window-minimum
  minimizer extraction over contigs.
- :mod:`kaptive_tpu.ops.mapper` — minimizer seeding, chaining, and banded
  extension: the device replacement for the reference's wrapped rammappy
  (minimap2-class) nucleotide mapper.
"""
