r"""kaptive-tpu: an accelerator-native bacterial surface-antigen locus-typing framework.

A from-scratch JAX/XLA re-design of the capabilities of Kaptive 3
(reference: ``/root/reference/src/kaptive``): *in silico* K/O/OC-locus serotyping
of genome assemblies against decentralised GenBank+TOML reference databases,
plus database lifecycle management, result conversion, multi-locus comparison
with interactive plots, and a BGC annotate/predict/train toolkit.

Architecture (accelerator-first, not a port):

- The reference wraps a Rust minimap2-class mapper (``rammappy``) and ~25 Numba
  CPU kernels.  Here the nucleotide mapping core (minimizer seeding, chaining,
  banded Smith-Waterman-Gotoh extension) and the protein identity DP run on the
  device (an NVIDIA GPU, or the CPU) via JAX and a CUDA kernel
  (``kaptive_tpu.ops``), batched over genes/assemblies with fixed shapes and
  length masks.
- The compiled reference database is packed into flat device-ready arrays
  (``kaptive_tpu.db``) and replicated (or locus-sharded) across a
  ``jax.sharding.Mesh``; assembly batches stream data-parallel via ``shard_map``
  (``kaptive_tpu.parallel``).
- Host-side orchestration (FASTA/GenBank parsing, report formatting, tiny
  array glue between device phases) lives in ``kaptive_tpu.core`` /
  ``kaptive_tpu.serotyping`` as vectorised numpy mirroring the reference's
  Structure-of-Arrays semantics exactly, so typing calls match.
"""

import os as _os
from pathlib import Path as _Path

from kaptive_tpu._version import __version__

__all__ = ["__version__"]

# Persistent XLA compile cache: ``$JAX_COMPILATION_CACHE_DIR`` when set (JAX
# reads it itself), else this fixed path inside the checkout — the path is part
# of the cache key, so it must not move between runs.
DEFAULT_JAX_CACHE = _Path(__file__).resolve().parent.parent / ".jax_cache"


def _enable_persistent_compilation_cache() -> None:
    import jax

    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", str(DEFAULT_JAX_CACHE))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


_enable_persistent_compilation_cache()
