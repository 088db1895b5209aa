"""Differential oracle: run the REFERENCE Kaptive decision layers in-process.

The bit-identity bar (BASELINE.md) asks that typing calls match reference
Kaptive 3.  The reference's native wheels (rammappy / gb-io / pyfgs) and numba
are not installable in this image (zero egress), but everything downstream of
the mapper is pure numpy wrapped in ``@njit`` decorators.  This shim makes the
reference engine runnable read-only from ``/root/reference``:

1. ``numba`` is stubbed with identity decorators (kernels run as plain
   Python — fine at test scale);
2. ``rammappy`` is stubbed with an ``Aligner`` that replays OUR device mapper's
   hits through rammappy's hit-object interface, so the reference's
   ``Alignments.from_mapping_iterators`` ingests exactly what our pipeline saw;
3. our compiled :class:`kaptive_tpu.db.Database` is converted field-for-field
   into the reference's ``Database`` dataclass.

With those three pieces, ``kaptive.serotyping.Serotyper`` runs end to end and
its ``SerotypingResult`` / ``KaptiveRow`` bytes become the golden oracle for
ours.  Nothing from the reference tree is copied into this repo; it is
imported at test time and tests skip when the tree is absent.
"""

from __future__ import annotations

import sys
import types
from pathlib import Path

import numpy as np

REFERENCE_SRC = Path("/root/reference/src")


def reference_available() -> bool:
    return (REFERENCE_SRC / "kaptive" / "serotyping" / "core.py").exists()


# ---------------------------------------------------------------------------
# Stub modules
# ---------------------------------------------------------------------------

def _install_numba_stub() -> None:
    if "numba" in sys.modules:
        return
    numba = types.ModuleType("numba")

    def njit(*args, **kwargs):  # supports @njit, @njit(sig), @njit(parallel=...)
        if len(args) == 1 and callable(args[0]) and not kwargs:
            return args[0]

        def deco(fn):
            return fn

        return deco

    numba.njit = njit  # type: ignore[attr-defined]
    numba.jit = njit  # type: ignore[attr-defined]
    numba.prange = range  # type: ignore[attr-defined]
    sys.modules["numba"] = numba


class _FakeStrand:
    def __init__(self, forward: bool) -> None:
        self.forward = forward

    def __repr__(self) -> str:
        return "Strand.Forward" if self.forward else "Strand.Reverse"


class _FakeHit:
    """One mapper hit in the attribute shape rammappy exposes
    (consumed at reference ``core/alignment.py:409-446``)."""

    __slots__ = (
        "target_name", "target_len", "target_start", "target_end",
        "query_start", "query_end", "strand", "block_len", "matches",
        "edit_distance", "score", "mapq", "is_primary", "is_supplementary",
        "is_spliced", "divergence", "cs", "md", "cigar",
    )

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw[k])


class _FakeFiltering:
    def __init__(self):
        self.best_n = 100
        self.pri_ratio = 0.8


class _FakeOptions:
    def __init__(self):
        self.filtering = _FakeFiltering()


class _FakeIndex:
    def __init__(self, contig_seqs):
        self.contig_seqs = contig_seqs


class _FakeAligner:
    """Replays pre-registered hits; batch order == DB gene order."""

    def __init__(self, index=None, preset=None, do_cigar=False, do_cs=False, do_md=False):
        self.index = index
        self.options = _FakeOptions()

    def map_batch(self, gene_seqs):
        provider = sys.modules["rammappy"]._BATCH_PROVIDER
        if provider is None:
            raise RuntimeError("ref_oracle: no hit provider registered")
        return provider(len(gene_seqs))


def _install_rammappy_stub() -> None:
    if "rammappy" in sys.modules:
        return
    rammappy = types.ModuleType("rammappy")

    class Preset:
        pass

    class Index:
        @staticmethod
        def build(contig_seqs):
            return _FakeIndex(contig_seqs)

    align = types.ModuleType("rammappy.align")
    align.Aligner = _FakeAligner

    fasta = types.ModuleType("rammappy.fasta")

    def parse_fasta_bytes(data: bytes):
        records = []
        for chunk in data.split(b">"):
            if not chunk.strip():
                continue
            header, _, body = chunk.partition(b"\n")
            seq = body.replace(b"\n", b"").replace(b"\r", b"")
            records.append((header.split()[0].decode(), np.frombuffer(seq, dtype=np.uint8)))
        return records

    fasta.parse_fasta_bytes = parse_fasta_bytes

    rammappy.Preset = Preset
    rammappy.Index = Index
    rammappy.align = align
    rammappy.fasta = fasta
    rammappy._BATCH_PROVIDER = None
    sys.modules["rammappy"] = rammappy
    sys.modules["rammappy.align"] = align
    sys.modules["rammappy.fasta"] = fasta


def _install_pyfgs_stub() -> None:
    """Import-time stand-in for the pyfgs wheel (only needed so that
    ``kaptive.bgc`` subpackage imports resolve; kernel tests never call it)."""
    if "pyfgs" in sys.modules:
        return
    pyfgs = types.ModuleType("pyfgs")

    class GeneFinder:  # pragma: no cover - never invoked by the oracle tests
        def __init__(self, *a, **k):
            raise RuntimeError("ref_oracle: pyfgs stub is import-only")

    pyfgs.GeneFinder = pyfgs.TrainingInfo = GeneFinder  # type: ignore[attr-defined]
    sys.modules["pyfgs"] = pyfgs


def load_reference():
    """Install stubs and import the reference package from /root/reference."""
    _install_numba_stub()
    _install_rammappy_stub()
    _install_pyfgs_stub()
    if str(REFERENCE_SRC) not in sys.path:
        sys.path.insert(0, str(REFERENCE_SRC))
    import kaptive  # noqa: F401
    import kaptive.serotyping.core  # noqa: F401
    import kaptive.serotyping.io  # noqa: F401

    return sys.modules["kaptive"]


# ---------------------------------------------------------------------------
# Converters: our objects -> reference objects
# ---------------------------------------------------------------------------

def to_reference_db(our_db):
    """Field-for-field conversion into the reference Database dataclass."""
    load_reference()
    from kaptive.core.interval import Intervals as RefIntervals
    from kaptive.core.seq import Sequences as RefSequences
    from kaptive.db.core import Database as RefDatabase
    from kaptive.db.models import DatabaseMetadata as RefMeta
    from kaptive.db.models import Phenotypes as RefPhenotypes

    def seqs(s):
        return RefSequences(
            ids=tuple(s.ids), seqs=np.asarray(s.seqs, dtype=np.uint8),
            offsets=np.asarray(s.offsets, dtype=np.int32),
            lengths=np.asarray(s.lengths, dtype=np.int32),
        )

    m = our_db.metadata
    meta = RefMeta(
        name=m.name, keyword=m.keyword, genbank=m.genbank, organism=m.organism,
        taxon=m.taxon, antigen=m.antigen, pathway=m.pathway, version=m.version,
        id_threshold=m.id_threshold, doi=list(m.doi), owner=m.owner, repo=m.repo,
        branch=m.branch, contact=dict(m.contact),
        phenotype_logic=dict(m.phenotype_logic), antigenic_units=dict(m.antigenic_units),
    )
    p = our_db.phenotypes
    phen = RefPhenotypes(
        ids=np.asarray(p.ids), locus_masks=np.asarray(p.locus_masks),
        extra_masks=np.asarray(p.extra_masks), inactive_masks=np.asarray(p.inactive_masks),
        extra_counts=np.asarray(p.extra_counts), priorities=np.asarray(p.priorities),
        as_suffix=np.asarray(p.as_suffix),
    )
    gi = our_db.gene_intervals
    return RefDatabase(
        metadata=meta,
        loci=seqs(our_db.loci),
        serotypes=tuple(our_db.serotypes),
        locus_gene_offsets=np.asarray(our_db.locus_gene_offsets),
        locus_gene_lengths=np.asarray(our_db.locus_gene_lengths),
        gene_intervals=RefIntervals(
            starts=np.asarray(gi.starts), ends=np.asarray(gi.ends),
            strands=np.asarray(gi.strands),
        ),
        genes=seqs(our_db.genes),
        translations=seqs(our_db.translations),
        extra_genes=np.asarray(our_db.extra_genes),
        gene_locus_indices=np.asarray(our_db.gene_locus_indices),
        cluster_keys=tuple(our_db.cluster_keys),
        gene_cluster_ids=np.asarray(our_db.gene_cluster_ids),
        description_keys=tuple(our_db.description_keys),
        gene_description_ids=np.asarray(our_db.gene_description_ids),
        gene_positions=np.asarray(our_db.gene_positions),
        phenotypes=phen,
        loci_sketches=None,  # unused by the Serotyper
    )


def to_reference_genome(our_genome):
    load_reference()
    from kaptive.core.genome import GenomeAssembly as RefGenome
    from kaptive.core.seq import Sequences as RefSequences

    contigs = our_genome.contigs
    return RefGenome(
        id=our_genome.id,
        contigs=RefSequences(
            ids=tuple(contigs.ids), seqs=np.asarray(contigs.seqs, dtype=np.uint8),
            offsets=np.asarray(contigs.offsets, dtype=np.int32),
            lengths=np.asarray(contigs.lengths, dtype=np.int32),
        ),
    )


def _hits_by_gene(our_alns, n_genes: int):
    """Bucket our mapper's flat hit rows into per-gene hit-object lists,
    preserving row order (rows arrive sorted by gene already)."""
    lists: list[list[_FakeHit]] = [[] for _ in range(n_genes)]
    for r in range(len(our_alns)):
        gene = int(our_alns.q_names_dict[our_alns.q_name_ids[r]])
        cig = our_alns.cigars[r]
        cigar_bytes = b""
        if len(cig):
            chars = b"MIDNSHP=XB"
            cigar_bytes = b"".join(
                b"%d%c" % (int(op) >> 4, chars[int(op) & 0xF]) for op in cig
            )
        lists[gene].append(
            _FakeHit(
                target_name=our_alns.t_names_dict[our_alns.t_name_ids[r]].encode("ascii"),
                target_len=int(our_alns.t_lengths[r]),
                target_start=int(our_alns.t_starts[r]),
                target_end=int(our_alns.t_ends[r]),
                query_start=int(our_alns.q_starts[r]),
                query_end=int(our_alns.q_ends[r]),
                strand=_FakeStrand(bool(our_alns.strands[r] == 1)),
                block_len=int(our_alns.lengths[r]),
                matches=int(our_alns.matches[r]),
                edit_distance=int(our_alns.mismatches[r]),
                score=int(our_alns.scores[r]),
                mapq=int(our_alns.qualities[r]),
                is_primary=bool(our_alns.is_primary[r]),
                is_supplementary=bool(our_alns.is_supplementary[r]),
                is_spliced=bool(our_alns.is_spliced[r]),
                divergence=float(our_alns.divergence[r]),
                cs=None,
                md=None,
                cigar=cigar_bytes,
            )
        )
    return lists


def reference_serotype(our_db, our_genome, our_alns, **knobs):
    """Run the reference Serotyper on our genome, feeding it our mapper's hits.

    Returns the reference's SerotypingResult.
    """
    kaptive = load_reference()
    from kaptive.serotyping.core import Serotyper as RefSerotyper

    ref_db = to_reference_db(our_db)
    ref_genome = to_reference_genome(our_genome)
    hits = _hits_by_gene(our_alns, len(our_db.genes))

    sys.modules["rammappy"]._BATCH_PROVIDER = lambda n: iter(hits)
    try:
        ser = RefSerotyper(ref_db, **knobs)
        return ser(ref_genome)
    finally:
        sys.modules["rammappy"]._BATCH_PROVIDER = None


def reference_row_bytes(ref_result) -> bytes:
    load_reference()
    from kaptive.serotyping.io import KaptiveRow as RefRow

    return bytes(RefRow.from_result(ref_result))
