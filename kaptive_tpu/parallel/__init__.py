r"""Multi-device parallelism: device meshes, sharded typing steps, batch pipelines.

The reference is single-process CPU (SURVEY.md §2.3); these components are
designed fresh for accelerators: data parallelism over assemblies via
``shard_map`` with the compiled database replicated, plus an optional
gene-table-sharded mode whose per-locus scores merge with ``psum`` before
best-locus selection.
"""

from kaptive_tpu.parallel.mesh import make_mesh
from kaptive_tpu.parallel.pipeline import stream_batches, stream_type
from kaptive_tpu.parallel.screen import locus_screen_batch, sharded_locus_screen

__all__ = [
    "locus_screen_batch",
    "make_mesh",
    "sharded_locus_screen",
    "stream_batches",
    "stream_type",
]
