"""Synthetic genome/database generators with known ground truth.

The reference deps (rammappy DBs, network-hosted GenBank databases) are
unavailable offline, so the oracle for end-to-end typing is construction:
assemblies are built from the database's own loci with controlled mutations /
fragmentation, making the true locus call known by design.
"""

import numpy as np

BASES = b"ACGT"
_BASES_ARR = np.frombuffer(BASES, dtype=np.uint8)


def random_dna(rng, n: int) -> bytes:
    return _BASES_ARR[rng.integers(0, 4, n)].tobytes()


def mutate_dna(rng, seq: bytes, sub_rate: float = 0.0, indel_rate: float = 0.0) -> bytes:
    out = bytearray()
    for c in seq:
        r = rng.random()
        if r < indel_rate / 2:
            continue
        if r < indel_rate:
            out.append(BASES[rng.integers(0, 4)])
        if rng.random() < sub_rate:
            choices = [b for b in BASES if b != c]
            out.append(choices[rng.integers(0, 3)])
        else:
            out.append(c)
    return bytes(out)


def revcomp(seq: bytes) -> bytes:
    return seq.translate(bytes.maketrans(b"ACGTacgt", b"TGCAtgca"))[::-1]


ASSEMBLY_KINDS = ("clean", "diverged", "fragmented", "draft")


def compose_assembly(rng, kind: str, locus: bytes, flank: int) -> bytes:
    """One assembly's FASTA bytes holding ``locus`` in random background.

    ``kind`` is one of :data:`ASSEMBLY_KINDS`: clean single contig, 1%-diverged
    locus, locus split mid-way across two contigs, or a draft (0.5% subs, ~24
    roughly equal contigs, so the locus spans a contig boundary or two).
    """
    if kind == "diverged":
        locus = mutate_dna(rng, locus, sub_rate=0.01)
    elif kind == "draft":
        locus = mutate_dna(rng, locus, sub_rate=0.005)
    contig = random_dna(rng, flank) + locus + random_dna(rng, flank)
    if kind in ("clean", "diverged"):
        return b">c1\n%s\n" % contig
    if kind == "fragmented":
        cut = flank + len(locus) // 2
        return b">c1\n%s\n>c2\n%s\n" % (contig[:cut], contig[cut:])
    n_pieces = 24
    step = len(contig) // n_pieces
    parts = [
        contig[j * step : (j + 1) * step if j < n_pieces - 1 else len(contig)]
        for j in range(n_pieces)
    ]
    return b"".join(b">c%d\n%s\n" % (j + 1, p) for j, p in enumerate(parts))


def make_orf(rng, n_codons: int) -> bytes:
    """Random open reading frame: ATG + non-stop codons + stop codon."""
    stops = {b"TAA", b"TAG", b"TGA"}
    codons = [b"ATG"]
    while len(codons) < n_codons - 1:
        c = bytes(BASES[i] for i in rng.integers(0, 4, 3))
        if c not in stops:
            codons.append(c)
    codons.append(b"TAA")
    return b"".join(codons)


# A biased codon vocabulary (one strongly preferred codon per amino acid, as
# in real genomes with strong codon-usage bias) — lets tests model the coding
# statistics gene-finding HMMs actually rely on.
_BIASED_CODONS = [
    b"GCG", b"CGC", b"AAC", b"GAT", b"TGC", b"CAG", b"GAA", b"GGC", b"CAT",
    b"ATC", b"CTG", b"AAA", b"TTC", b"CCG", b"AGC", b"ACC", b"TGG",
    b"TAC", b"GTG",
]


def make_biased_orf(rng, n_codons: int) -> bytes:
    """ORF drawn from a biased codon vocabulary (realistic coding statistics)."""
    idx = rng.integers(0, len(_BIASED_CODONS), n_codons - 2)
    return b"ATG" + b"".join(_BIASED_CODONS[i] for i in idx) + b"TAA"


def make_synthetic_db(tmp_path, rng, n_loci: int = 4, genes_per_locus: int = 5,
                      with_extra: bool = True, with_phenotypes: bool = True,
                      name: str = "TestDB", keyword: str = "test_db",
                      cluster_prefix: str = "wz"):
    """Write a synthetic GenBank+TOML locus database; return (gbk_path, truth dict).

    Each locus is spacer + alternating-strand ORF genes + spacer. Gene clusters
    are named 'wzA'..; locus KL1..KLn with serotype K1..Kn.
    """
    from kaptive_tpu.db.genbank import Feature, Location, Qualifier, Record, write_genbank

    records = []
    truth = {"loci": {}, "gene_seqs": {}}
    for li in range(n_loci):
        locus_name = f"KL{li + 1}"
        serotype = f"K{li + 1}"
        pos = 0
        seq_parts = []
        feats = [
            Feature("source", Location(0, 0, 1),
                    [Qualifier("note", f"locus: {locus_name}"), Qualifier("note", f"type: {serotype}")])
        ]
        gene_info = []
        for gi in range(genes_per_locus):
            spacer = random_dna(rng, int(rng.integers(80, 200)))
            seq_parts.append(spacer)
            pos += len(spacer)
            orf = make_orf(rng, int(rng.integers(100, 260)))
            strand = 1 if gi % 2 == 0 else -1
            cluster = f"{cluster_prefix}{chr(ord('A') + gi)}"
            gene_seq = orf if strand == 1 else revcomp(orf)
            seq_parts.append(gene_seq)
            feats.append(Feature("CDS", Location(pos, pos + len(orf), strand),
                                 [Qualifier("gene", cluster),
                                  Qualifier("product", f"protein {cluster}")]))
            gene_info.append((cluster, pos, pos + len(orf), strand, orf))
            pos += len(orf)
        tail = random_dna(rng, 150)
        seq_parts.append(tail)
        full = b"".join(seq_parts)
        feats[0].location = Location(0, len(full), 1)
        records.append(Record(locus_name, full, feats))
        truth["loci"][locus_name] = {"seq": full, "serotype": serotype, "genes": gene_info}

    if with_extra:
        # Extra genes record: IS elements / modifier genes without synteny
        extra_orf = make_orf(rng, 120)
        rec = Record("Extra_genes", extra_orf,
                     [Feature("source", Location(0, len(extra_orf), 1),
                              [Qualifier("note", "Extra genes: Extra_genes")]),
                      Feature("CDS", Location(0, len(extra_orf), 1),
                              [Qualifier("gene", "wcaJ"), Qualifier("product", "extra modifier")])])
        records.append(rec)
        truth["extra"] = {"wcaJ": extra_orf}

    gbk = tmp_path / f"{name}.gbk"
    gbk.write_bytes(write_genbank(records))

    logic = ""
    if with_phenotypes:
        logic = (
            '[phenotype_logic."K1-like"]\n'
            'loci = ["KL1"]\n'
            'extra_genes = ["wcaJ"]\n'
            "priority = 60\n"
            '[phenotype_logic."K2-deficient"]\n'
            'loci = ["KL2"]\n'
            'inactive_genes = ["wz*"]\n'
            "priority = 55\n"
        )
    toml = f'''name = "{name}"
keyword = "{keyword}"
genbank = "{name}.gbk"
organism = "Testus syntheticus"
taxon = 12345
antigen = "Capsular polysaccharide"
pathway = "Wzx/Wzy-dependent"
version = "1.0.0"
id_threshold = 82.5
doi = ["TBD"]
owner = "example"
repo = "example-db"
branch = "main"
[contact]
"Test Curator" = "test@example.org"
{logic}'''
    (tmp_path / f"{name}.toml").write_text(toml)
    return gbk, truth


def make_genome_from_locus(rng, truth, locus_name: str, contig_name: str = "contig1",
                           flank: int = 3000, sub_rate: float = 0.0):
    """Assembly FASTA bytes containing the given locus embedded in random background."""
    locus_seq = truth["loci"][locus_name]["seq"]
    if sub_rate > 0:
        locus_seq = mutate_dna(rng, locus_seq, sub_rate=sub_rate)
    contig = random_dna(rng, flank) + locus_seq + random_dna(rng, flank)
    return b">%s\n%s\n" % (contig_name.encode(), contig)
