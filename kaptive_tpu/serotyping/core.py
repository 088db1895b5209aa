r"""The serotyping engine: map, score, reconstruct, classify, phenotype, call.

Capability parity with ``/root/reference/src/kaptive/serotyping/core.py`` (the
``Serotyper`` four-phase pipeline, :124-486) with the same knobs and decision
semantics, re-architected for batched device execution:

- the mapping phase is the device mapper (:mod:`kaptive_tpu.ops.mapper`,
  replacing the rammappy call at ref :147-155), batched over assemblies;
- every decision phase runs **once per batch** over a flat hit table
  (:mod:`kaptive_tpu.serotyping.analysis`), not once per genome;
- the protein-identity DP for every surviving hit of every assembly is one
  bucketed device sweep (:mod:`kaptive_tpu.ops.swg`).

Only sequence extraction against each genome's own contigs and final
result-object assembly iterate per assembly.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from kaptive_tpu import __version__
from kaptive_tpu.core.genome import GenomeAssembly
from kaptive_tpu.core.pairwise import PairwiseAligner
from kaptive_tpu.core.seq import Sequences
from kaptive_tpu.db import Database
from kaptive_tpu.ops.mapper import MapperParams
from kaptive_tpu.serotyping.analysis import (
    HitTable,
    call_typeability,
    edge_partial_mask,
    pick_best_loci,
    reconstruct_loci,
    resolve_phenotypes,
)
from kaptive_tpu.serotyping.models import (
    GeneHits,
    GeneState,
    LocusPieces,
    SerotypingResult,
)


def _byte_vocab(strings, pad: int = 0) -> np.ndarray:
    r"""Encode a string vocabulary as a fixed-width bytes array sized to fit."""
    encoded = [s.encode("utf-8") for s in strings]
    width = max((len(b) for b in encoded), default=1) + pad
    return np.array(encoded, dtype=f"S{max(width, 1)}")


class Serotyper:
    r"""High-performance *in silico* serotyping engine for bacterial genome assemblies."""

    def __init__(
        self,
        db: Database,
        max_other_genes: int = 1,
        min_completeness: float = 0.5,
        allow_below_threshold: bool = False,
        mapper_params: MapperParams | None = None,
        scoring_metric: str = "scores",
        min_gene_coverage: float = 0.20,
        partial_edge_tolerance: int = 5,
        mesh=None,
    ) -> None:
        import dataclasses

        from kaptive_tpu.ops.swg import SwgLattice

        self._db = db
        self.max_other_genes = max_other_genes
        self.min_completeness = min_completeness
        self.allow_below_threshold = allow_below_threshold
        # scoring_metric is stored for API parity only: the reference shares
        # the wart of never reading it (``serotyping/core.py:62-98`` accepts it
        # but the scoring phase always uses the q_cov sum).
        self.scoring_metric = scoring_metric
        self.min_gene_coverage = min_gene_coverage
        self.partial_edge_tolerance = partial_edge_tolerance
        # Optional jax.sharding.Mesh with (data, model) axes: assemblies shard
        # over data, the gene table over model, DP pairs over every device.
        self.mesh = mesh

        # Frozen DP shape lattices derived from what this database can ever
        # produce, so every banded-SWG shape is known up front and compiled
        # once (during :meth:`warmup` or the first batch) — steady state never
        # pays a device compile.  Protein pairs: hit translation vs DB
        # translation, both bounded by the longest DB protein (+25% slack for
        # insertion-stretched hits).  Extension pairs: gene vs chain-projected
        # contig window, bounded by the longest DB gene plus window padding.
        from kaptive_tpu.platform import on_gpu

        # On a GPU batch whole phases into few launches (384 covers a
        # 16-assembly batch's typical pair count in one); on CPU keep small
        # batches — the lax path pays real compute for padding.  The batch is
        # rounded to a multiple of lcm(device-count batch quantum, 8) at
        # CONSTRUCTION so warmup precompiles exactly the shapes the runtime
        # launches (a runtime-side round-up would compile fresh shapes on
        # first use).
        import math

        n_dev = int(mesh.devices.size) if mesh is not None else 1
        unit = math.lcm(-(-16 // n_dev) * n_dev, 8)
        dp_batch = 384 if on_gpu() else 128
        dp_batch = -(-dp_batch // unit) * unit
        tail = math.lcm(unit, 8) * max(1, 96 // math.lcm(unit, 8))
        max_prot = int(db.translations.lengths.max()) if len(db.translations) else 64
        self._protein_lattice = SwgLattice.for_max_len(
            max_prot, len_slack=max(16, max_prot // 4), batch=dp_batch,
            tail_batch=tail if tail < dp_batch else 0,
        )
        max_gene = int(db.genes.lengths.max()) if len(db.genes) else 256
        # Row tiers: well-seeded chains project windows of ~gene length plus
        # window padding (the common case); only drift-stretched chains need
        # the full worst-case rows, so they get their own (rarely hit) tier.
        ext_rows_typ = -(-(max_gene + 192) // 64) * 64
        ext_rows_max = -(-(max_gene + 768) // 64) * 64
        self._ext_lattice = SwgLattice.for_max_len(
            max_gene, len_slack=768, widths=(128, 512), batch=dp_batch,
            row_tiers=tuple(sorted({ext_rows_typ, ext_rows_max})),
        )
        mp = mapper_params or MapperParams()
        if mp.lattice is None:
            mp = dataclasses.replace(mp, lattice=self._ext_lattice)
        self.mapper_params = mp
        self._protein_aligner = PairwiseAligner(mesh=mesh, lattice=self._protein_lattice)

        # String vocabularies as width-fitted byte arrays for fast fancy-index
        # construction of GeneHits (the reference re-encodes per hit per call).
        self._gene_id_bytes = _byte_vocab(db.genes.ids)
        self._cluster_bytes = _byte_vocab(db.cluster_keys)
        self._descr_bytes = _byte_vocab(db.description_keys)
        # Mapper q_names convention: stringified DB gene indices.
        self._gene_names = tuple(str(i) for i in range(len(db.genes)))
        self._screen_tables = None  # lazy ScreenTables for :meth:`screen`

    def __call__(self, genome: GenomeAssembly | str | Path) -> SerotypingResult | None:
        return self.batch([genome])[0]

    def batch(self, genomes: list[GenomeAssembly | str | Path]) -> list[SerotypingResult | None]:
        r"""Type a batch of assemblies with batch-amortised device dispatches."""
        assemblies, alns_list = self.map_batch(genomes)
        return self.finish_batch(assemblies, alns_list)

    def map_batch(self, genomes: list[GenomeAssembly | str | Path]):
        r"""Device mapping stage only: (assemblies, per-assembly Alignments).

        Split from :meth:`finish_batch` so a streaming caller can overlap the
        next batch's device mapping with the current batch's decision phases
        (:func:`kaptive_tpu.parallel.pipeline.stream_type` does) — each phase
        boundary re-enters the device's work queue, so overlapping the waits
        saves up to a phase per batch.
        """
        from kaptive_tpu.ops.mapper import map_genes_batch
        from kaptive_tpu.utils.profiling import phase_timer

        n_asm = len(genomes)
        if n_asm == 0:
            return [], []
        with phase_timer("type.ingest"):
            assemblies = [GenomeAssembly.ensure(g) for g in genomes]
        with phase_timer("type.map"):
            alns_list = map_genes_batch(
                self._db.gene_index, assemblies, self._gene_names,
                self.mapper_params, mesh=self.mesh,
            )
        return assemblies, alns_list

    def finish_batch(
        self, assemblies: list, alns_list: list
    ) -> list[SerotypingResult | None]:
        r"""Decision stages over pre-computed mapper hits (see :meth:`map_batch`)."""
        from kaptive_tpu.utils.profiling import phase_timer

        db = self._db
        n_asm = len(assemblies)
        if n_asm == 0:
            return []

        with phase_timer("type.decide"):
            table = HitTable.from_alignments(alns_list)
            pick = pick_best_loci(db, table, n_asm, self.min_gene_coverage)
            recon = reconstruct_loci(db, table, pick, n_asm)
            hits = recon.hits
            bounds = np.searchsorted(hits.asm, np.arange(n_asm + 1))
            piece_bounds = np.searchsorted(recon.piece_asm, np.arange(n_asm + 1))

        # --- sequence extraction (per assembly: contigs differ) + one batched
        # translation with frame compensation and stop-codon cut (ref :352-360).
        with phase_timer("type.extract"):
            gene_seq_parts: list[Sequences] = []
            locus_seq_parts: list[Sequences] = []
            for a, genome in enumerate(assemblies):
                rows = slice(bounds[a], bounds[a + 1])
                gene_seq_parts.append(
                    genome.contigs.extract_intervals(
                        hits.ctg[rows].astype(np.uint32),
                        _t_intervals(hits, rows),
                        new_ids=tuple(db.genes.ids[i] for i in hits.gene[rows]),
                    )
                )
                p = slice(piece_bounds[a], piece_bounds[a + 1])
                if piece_bounds[a + 1] > piece_bounds[a]:
                    locus_seq_parts.append(
                        genome.contigs.extract(
                            recon.piece_ctg[p].astype(np.int32),
                            recon.piece_lo[p].astype(np.int32),
                            recon.piece_hi[p].astype(np.int32),
                            recon.piece_orient[p],
                        )
                    )
                else:
                    locus_seq_parts.append(Sequences.empty())
            gene_seqs = Sequences.concat(gene_seq_parts)
            frames = (-hits.q_start) % 3
            prot_seqs = gene_seqs.translate(frames=frames, to_stop=True)

        # --- gene states before identity: contig-edge partials, then
        # truncation below 90% translated coverage (ref :362-377).
        partial = edge_partial_mask(hits, self.partial_edge_tolerance)
        ref_nt_len = db.genes.lengths[hits.gene]
        prot_covs = (prot_seqs.lengths * 3.0) / ref_nt_len
        states = np.where(
            partial,
            GeneState.PARTIAL.value,
            np.where(prot_covs < 0.90, GeneState.TRUNCATED.value, GeneState.NORMAL.value),
        ).astype(np.int8)
        coverages = np.clip(prot_covs * 100.0, 0.0, 100.0).astype(np.float32)

        # --- protein identity DP: every hit of every assembly, one sweep.
        with phase_timer("type.protein_dp"):
            prot_alns = self._protein_aligner(prot_seqs, db.translations[hits.gene])
            pidents = prot_alns.pidents.astype(np.float32)

        with phase_timer("type.finalize"):
            # Spurious outside-locus homologies below the identity threshold
            # vanish from the result entirely (ref :381-391).
            keep = recon.is_inside | (pidents >= db.metadata.id_threshold)
            if not keep.all():
                hits = hits.take(keep)
                gene_seqs = gene_seqs[keep]  # type: ignore[assignment]
                prot_seqs = prot_seqs[keep]  # type: ignore[assignment]
                states = states[keep]
                pidents = pidents[keep]
                coverages = coverages[keep]
                is_expected = recon.is_expected[keep]
                is_extra = recon.is_extra[keep]
                is_inside = recon.is_inside[keep]
                bounds = np.searchsorted(hits.asm, np.arange(n_asm + 1))
            else:
                is_expected, is_extra, is_inside = (
                    recon.is_expected, recon.is_extra, recon.is_inside,
                )

            # Full-length hits under the identity threshold are NOVEL (ref :393-394).
            states[(states == GeneState.NORMAL.value) & (pidents < db.metadata.id_threshold)] = (
                GeneState.NOVEL.value
            )

            # Phenotype rules over the whole batch (ref :398-442).
            intact = (states == GeneState.NORMAL.value) | (states == GeneState.PARTIAL.value)
            active = np.zeros((n_asm, len(db.cluster_keys)), dtype=bool)
            active[hits.asm[intact], db.gene_cluster_ids[hits.gene[intact]]] = True
            phenotypes = resolve_phenotypes(db, pick.best_locus, active)

            # Typeability (ref :444-459).
            intruding = is_inside & ~is_expected & ~is_extra
            unexpected_counts = np.zeros(n_asm, dtype=np.int64)
            np.add.at(
                unexpected_counts,
                hits.asm[intruding & (states != GeneState.TRUNCATED.value)],
                1,
            )
            inside_novel = np.zeros(n_asm, dtype=bool)
            inside_novel[hits.asm[is_inside & (states == GeneState.NOVEL.value)]] = True
            typeable = call_typeability(
                completeness=recon.found_completeness,
                min_completeness=self.min_completeness,
                unexpected_counts=unexpected_counts,
                max_other_genes=self.max_other_genes,
                has_inside_novel=inside_novel,
                allow_below_threshold=self.allow_below_threshold,
            )

            results = [
                self._assemble_result(
                    assemblies[a], a, pick, recon, hits,
                    slice(bounds[a], bounds[a + 1]),
                    slice(piece_bounds[a], piece_bounds[a + 1]),
                    gene_seqs, prot_seqs, states, pidents, coverages,
                    is_expected, is_extra, is_inside,
                    locus_seq_parts[a], phenotypes[a], bool(typeable[a]),
                )
                for a in range(n_asm)
            ]
        return results

    def screen(self, genomes: list) -> tuple[list, np.ndarray, np.ndarray]:
        r"""Fast approximate batch pre-classification (scoring phase only).

        Runs the fully-jitted screening step (:mod:`kaptive_tpu.parallel.screen`):
        device minimizer scan -> gene-table tallies -> matmul locus scoring with
        the reference's completeness^3 weighting (ref ``serotyping/core.py:164-207``).
        Orders of magnitude cheaper than full typing and its best-locus calls
        agree with the full pipeline on clean assemblies, but it produces no
        gene table, reconstruction, phenotype or confidence call — use it to
        triage large batches (``kaptive-tpu type --screen-only``) before full
        typing, not as a substitute.  On a multi-device mesh the assemblies
        shard over ``data`` and the gene table over ``model``.

        Returns ``(assemblies, best_locus_indices, weighted_scores)`` where
        ``weighted_scores`` is (B, n_loci).
        """
        from kaptive_tpu.ops.minimizer import bucket_length
        from kaptive_tpu.parallel.screen import (
            ScreenTables,
            encode_assemblies_to_batch,
            locus_screen_batch,
            sharded_locus_screen,
        )

        assemblies = [GenomeAssembly.ensure(g) for g in genomes]
        if not assemblies:
            return [], np.empty(0, dtype=np.int32), np.empty((0, len(self._db.loci)))
        if self._screen_tables is None:
            self._screen_tables = ScreenTables.from_database(self._db)
        tables = self._screen_tables
        n = len(assemblies)
        codes = encode_assemblies_to_batch(assemblies)
        width = bucket_length(codes.shape[1])
        # Stable jit shapes across batches: bucket the width axis, and pad the
        # batch axis to a power of two so a trailing partial batch reuses a
        # compiled program instead of compiling a fresh one (sentinel rows
        # yield no tallies).
        b_pad = 1
        while b_pad < n:
            b_pad *= 2
        if self.mesh is not None and int(self.mesh.devices.size) > 1:
            # shard_map also needs the leading dim divisible by the data axis.
            data_axis = int(self.mesh.shape.get("data", 1))
            b_pad = -(-b_pad // data_axis) * data_axis
        if (b_pad, width) != codes.shape:
            codes = np.pad(
                codes,
                ((0, b_pad - n), (0, width - codes.shape[1])),
                constant_values=4,
            )
        if self.mesh is not None and int(self.mesh.devices.size) > 1:
            best, weighted = sharded_locus_screen(self.mesh, codes, tables)
        else:
            best, weighted = locus_screen_batch(
                codes, *self._screen_device_tables(), n_genes=len(self._db.genes)
            )
        return assemblies, np.asarray(best)[:n], np.asarray(weighted)[:n]

    def _screen_device_tables(self):
        r"""Device copies of the screen tables, uploaded once (cached)."""
        if getattr(self, "_screen_dev", None) is None:
            import jax.numpy as jnp

            t = self._screen_tables
            self._screen_dev = tuple(
                jnp.asarray(x)
                for x in (
                    t.table_hashes, t.table_genes, t.gene_locus_onehot,
                    t.expected_per_locus, t.gene_minimizer_counts,
                )
            )
        return self._screen_dev

    def warmup(
        self, genome_length: int = 5_500_000, batch_size: int = 8, seed: int = 0
    ) -> float:
        r"""Compile every device program the typing pipeline can dispatch.

        Deployments (and ``kaptive type --precompile``) call this once before
        streaming real assemblies: it (1) pre-dispatches every frozen DP
        lattice shape, then (2) types one synthetic batch of
        ``batch_size`` assemblies of ``genome_length`` (pick the size class of
        the real inputs — the scan programs are keyed on the power-of-two
        genome bucket), each containing one DB locus, which compiles the scan
        /match/chain programs and the decision-layer jits.  Compiled programs
        land in the persistent XLA cache (see :mod:`kaptive_tpu`), so a
        later process skips the compile cost entirely.  Returns elapsed
        seconds.
        """
        import io
        import time

        from kaptive_tpu.ops.mapper import SCAN_CHUNK

        t0 = time.perf_counter()
        self._precompile_dp_lattices()
        db = self._db
        rng = np.random.default_rng(seed)
        bases = np.frombuffer(b"ACGT", dtype=np.uint8)
        # The device stages run in fixed SCAN_CHUNK slices, so one chunk's
        # worth of genomes compiles every program regardless of the
        # production batch size.
        batch_size = min(batch_size, SCAN_CHUNK)
        genomes = []
        for i in range(batch_size):
            li = i % max(len(db.loci), 1)
            locus = db.loci.seqs[
                db.loci.offsets[li] : db.loci.offsets[li] + db.loci.lengths[li]
            ].tobytes() if len(db.loci) else b""
            flank = max((genome_length - len(locus)) // 2, 1)
            contig = (
                bases[rng.integers(0, 4, flank)].tobytes()
                + locus
                + bases[rng.integers(0, 4, flank)].tobytes()
            )
            genomes.append(
                GenomeAssembly.from_stream(
                    io.BytesIO(b">c1\n%s\n" % contig), f"warmup{i}"
                )
            )
        self.batch(genomes)
        return time.perf_counter() - t0

    def _precompile_dp_lattices(self) -> None:
        r"""Dispatch one dummy problem per frozen DP bucket shape."""
        import jax.numpy as jnp

        from kaptive_tpu.core.pairwise import blosum62_matrix
        from kaptive_tpu.ops.mapper import NT_GAP_EXTEND, NT_GAP_OPEN, _NT_MATRIX
        from kaptive_tpu.ops.swg import banded_swg, banded_swg_lax_cigars

        prot_matrix = np.asarray(blosum62_matrix(), dtype=np.int32)
        aligner = self._protein_aligner
        plans = [
            (self._protein_lattice, prot_matrix, aligner.gap_open, aligner.gap_extend),
            (self._ext_lattice, _NT_MATRIX, NT_GAP_OPEN, NT_GAP_EXTEND),
        ]
        jobs = []
        for lattice, matrix, go, ge in plans:
            for rows, w, b in lattice.shapes():
                t_pad = w + 2
                args = (
                    np.zeros((b, rows), dtype=np.uint8),
                    np.ones(b, dtype=np.int32),
                    np.zeros((b, rows + 2 * t_pad), dtype=np.uint8),
                    np.ones(b, dtype=np.int32),
                    np.zeros(b, dtype=np.int32),
                    np.ones(b, dtype=np.int32),
                )
                statics = dict(
                    gap_open=go, gap_extend=ge, rows_max=rows, w_pad=w, t_pad=t_pad
                )
                jobs.append((args, matrix, statics, matrix is _NT_MATRIX))

        def _compile_one(job):
            args, matrix, statics, is_nt = job
            out = [banded_swg(*args, matrix, **statics).scores]
            if self.mapper_params.emit_cigars and is_nt:
                res, *_ = banded_swg_lax_cigars(
                    *(jnp.asarray(a) for a in args), jnp.asarray(matrix), **statics
                )
                out.append(res.scores)
            return out

        # Compilation dominates warmup and XLA compiles release the GIL —
        # overlap them.
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(8, len(jobs) or 1)) as pool:
            for outs in pool.map(_compile_one, jobs):
                for scores in outs:  # block so compile errors surface here
                    np.asarray(scores)

    def _assemble_result(
        self, genome, a, pick, recon, hits, rows, pieces,
        gene_seqs, prot_seqs, states, pidents, coverages,
        is_expected, is_extra, is_inside, locus_seqs, phenotype, typeable,
    ) -> SerotypingResult:
        db = self._db
        best = int(pick.best_locus[a])

        gene_hits = GeneHits(
            gene_indices=hits.gene[rows],
            q_starts=hits.q_start[rows],
            q_ends=hits.q_end[rows],
            t_indices=hits.ctg[rows].astype(np.uint32),
            t_starts=hits.t_start[rows],
            t_ends=hits.t_end[rows],
            strands=hits.strand[rows],
            is_expected=is_expected[rows],
            is_inside=is_inside[rows],
            is_extra=is_extra[rows],
            expected_positions=db.gene_positions[hits.gene[rows]].astype(np.int32),
            expected_strands=db.gene_intervals.strands[hits.gene[rows]],
            gene_ids=self._gene_id_bytes[hits.gene[rows]],
            cluster_names=self._cluster_bytes[db.gene_cluster_ids[hits.gene[rows]]],
            product_descriptions=self._descr_bytes[db.gene_description_ids[hits.gene[rows]]],
            coverages=coverages[rows],
        )
        locus_pieces = LocusPieces(
            ctg_indices=recon.piece_ctg[pieces].astype(np.uint32),
            starts=recon.piece_lo[pieces].astype(np.int32),
            ends=recon.piece_hi[pieces].astype(np.int32),
            strands=recon.piece_orient[pieces],
        )

        span_found = int(np.sum(recon.piece_hi[pieces] - recon.piece_lo[pieces]))
        span_ref = int(db.loci.lengths[best])
        pcov = min(100.0, span_found / span_ref * 100.0) if span_ref > 0 else 0.0
        discrepancy = float(span_found - span_ref) if len(locus_pieces) == 1 else float("nan")

        intact = pidents[rows][states[rows] == GeneState.NORMAL.value]
        pident = float(np.mean(intact)) if intact.size else 0.0

        missing = tuple(db.genes.ids[i] for i in np.flatnonzero(recon.missing_mask[a]))

        return SerotypingResult(
            kaptive_version=__version__,
            database_name=db.metadata.name,
            database_version=db.metadata.version,
            database_organism=db.metadata.organism,
            database_taxon=db.metadata.taxon,
            genome=genome.id,
            best_locus_idx=best,
            best_locus_name=db.loci.ids[best],
            best_locus_score=float(pick.raw_scores[a, best]),
            best_locus_completeness=float(recon.found_completeness[a]),
            length_discrepancy=discrepancy,
            gene_hits=gene_hits,
            gene_states=states[rows],
            locus_pieces=locus_pieces,
            locus_seqs=locus_seqs,
            gene_seqs=gene_seqs[rows],  # type: ignore[arg-type]
            translations=prot_seqs[rows],  # type: ignore[arg-type]
            percent_identity=pident,
            percent_coverage=pcov,
            protein_identities=pidents[rows],
            phenotype=phenotype,
            typeable=typeable,
            missing_expected_genes=missing,
        )


def _t_intervals(hits: HitTable, rows: slice):
    from kaptive_tpu.core.interval import Intervals

    return Intervals(hits.t_start[rows], hits.t_end[rows], hits.strand[rows])
