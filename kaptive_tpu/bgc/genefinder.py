r"""Frameshift-tolerant gene-finding HMM (FragGeneScan-class, on device).

The reference's BGC annotator wraps ``pyfgs`` (the Rust/C FragGeneScan
binding, ``/root/reference/src/kaptive/bgc/annotate.py:261-278``): an HMM
whose insertion/deletion states keep a gene intact across sequencing-error
frameshifts, where a plain six-frame ORF scan yields two fragments in
different frames.  This module is the device equivalent: a 7-state
codon-phase HMM decoded with a ``jax.lax.scan`` Viterbi (SURVEY.md §2.2 maps
pyfgs to exactly this construct), with codon-usage emissions estimated from
the reference database's own genes.

States (per strand): ``N`` (noncoding), ``C0/C1/C2`` (codon phase), and
``I0/I1/I2`` (inserted base after phase p).  Indel tolerance comes from

- insertions: ``Cp -> Ip`` (open), ``Ip -> Ip`` (extend), ``Ip -> C(p+1)``
  (resume) — an extra genomic base inside a codon;
- deletions: ``Cp -> C(p+2)%3`` — a lost genomic base, phase advances two in
  one step.

Emissions: completing a codon (entering ``C2``) scores the codon's log-odds
(coding codon-usage vs uniform background); in-frame stop codons are
forbidden inside a gene (−∞), so genes are maximal stop-free codon runs —
the probabilistic generalisation of ORF calling.  Gene entry earns a bonus on
a table-11 start codon and gene exit on a following in-frame stop, but both
remain *possible* without one so genes running off contig edges are still
called (FragGeneScan behaviour).

The decode returns per-position states; segment extraction, start-codon
refinement and frame-corrected translation (inserted bases dropped, deleted
bases restored as ``N``/``X``) happen in vectorised numpy on the tiny gene
segments.
"""

from __future__ import annotations

import functools

from dataclasses import dataclass

import jax
import numpy as np

from kaptive_tpu.bgc.orf import Orf
from kaptive_tpu.core.seq import BacterialTranslationTable

BIG = 1.0e9

# State indices.
N, C0, C1, C2, I0, I1, I2 = range(7)

# Codon ids (c0*16 + c1*4 + c2 over A=0 C=1 G=2 T=3).
STOP_IDS = (48, 50, 56)  # TAA TAG TGA
# NCBI table 11 start codons: TTG CTG ATT ATC ATA ATG GTG.
TABLE11_START_IDS = (62, 30, 15, 13, 12, 14, 46)

_DNA_LUT = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _DNA_LUT[_c] = _i
    _DNA_LUT[_c + 32] = _i


@dataclass(frozen=True, slots=True)
class GeneHmmParams:
    r"""Log-space HMM parameters (natural log)."""

    codon_logodds: np.ndarray  # (64,) coding codon log-odds vs background
    entry: float = -9.0  # N -> C0 at a non-start codon (edge/partial genes)
    start_bonus: float = 3.0  # added to entry on a table-11 start codon
    exit_stop: float = -2.0  # C2 -> N right before an in-frame stop codon
    exit_other: float = -15.0  # C2 -> N anywhere else (rare, e.g. truncations)
    indel: float = -8.0  # insertion open / deletion transition
    ins_extend: float = -1.0  # insertion extension
    coding_bonus: float = 0.25  # per-codon reward, folded into the codon emission
    # What makes the decode robust is the CONTENT term, exactly as in
    # FragGeneScan: with emissions learned from real (codon-biased) genes
    # (:meth:`from_sequences`), wrong-frame and intergenic codons score
    # negative per codon, so (a) after a sequencing-error indel the in-frame
    # continuation outscores exiting at the first wrong-frame stop by tens of
    # logits — the gene stays ONE call — and (b) merging across a spacer
    # bleeds score and never pays.  With :meth:`uniform` emissions (no codon
    # bias, e.g. random synthetic genes) the transition costs alone leave only
    # ~1-logit margins and behaviour degrades toward a plain ORF caller —
    # which is the information-theoretic limit: frames of random-codon genes
    # are statistically indistinguishable, for FragGeneScan too.

    @classmethod
    def from_sequences(cls, dna_seqs, **kw) -> "GeneHmmParams":
        r"""Estimate codon usage from a ragged DNA :class:`Sequences` batch
        (e.g. ``db.genes``) — the database's own genes are the best available
        model of the coding statistics the annotator will meet.

        The indel cost auto-adapts to the measured bias strength (unless
        given explicitly): with strong codon bias wrong-frame content scores
        negative, so a cheap indel (-8) safely buys frameshift tolerance;
        with weak/no bias (e.g. random synthetic genes) frames are
        statistically indistinguishable and a cheap indel would let the
        decode cross stop codons and swallow neighbouring genes — the indel
        is priced out (-12) and the HMM degrades gracefully toward a plain
        ORF caller, exactly the information-theoretic limit FragGeneScan
        shares."""
        counts = np.ones(64, dtype=np.float64)  # Laplace
        seqs, offsets, lengths = dna_seqs.seqs, dna_seqs.offsets, dna_seqs.lengths
        for i in range(len(offsets)):
            codes = _DNA_LUT[seqs[offsets[i] : offsets[i] + lengths[i]]]
            n_cod = len(codes) // 3
            if n_cod == 0:
                continue
            c = codes[: n_cod * 3].reshape(-1, 3).astype(np.int64)
            ok = (c < 4).all(axis=1)
            ids = c[ok, 0] * 16 + c[ok, 1] * 4 + c[ok, 2]
            counts += np.bincount(ids, minlength=64)
        freqs = counts / counts.sum()
        logodds = np.log(freqs * 64.0).astype(np.float32)
        logodds[list(STOP_IDS)] = -BIG  # stops cannot occur inside a gene
        nonstop = logodds[logodds > -1e8]
        bias_strength = -float(nonstop.mean())  # ~0 uniform, >0.5 real genomes
        if "indel" not in kw:
            kw["indel"] = -8.0 if bias_strength >= 0.4 else -12.0
        return cls(codon_logodds=logodds, **kw)

    @classmethod
    def uniform(cls, **kw) -> "GeneHmmParams":
        r"""No codon-usage preference: genes are scored purely by stop-free
        run length (the HMM generalisation of a plain ORF scan).  Without a
        content signal the indel states are priced high (see
        :meth:`from_sequences`)."""
        logodds = np.zeros(64, dtype=np.float32)
        logodds[list(STOP_IDS)] = -BIG
        kw.setdefault("indel", -12.0)
        return cls(codon_logodds=logodds, **kw)


@functools.partial(jax.jit, static_argnames=("indel", "ins_extend"))
def _viterbi_states(codemit, entry_b, exit_b, *, indel: float, ins_extend: float):
    r"""Forward Viterbi + reverse backtrace, both as ``lax.scan``; returns the
    per-position state sequence (L,) int8.

    ``codemit[i]`` is the emission collected on entering ``C2`` at position
    ``i`` (codon at ``[i-2, i+1)``, with the per-codon coding bonus folded
    in); ``entry_b[i]`` / ``exit_b[i]`` are the N->C0 / C2->N transition
    scores at position ``i`` (start/stop context already folded in on host).
    """
    import jax
    import jax.numpy as jnp

    NEG = jnp.float32(-BIG)
    dele = jnp.float32(indel)
    inso = jnp.float32(indel)
    inse = jnp.float32(ins_extend)

    def step(v, inputs):
        ce, eb, xb = inputs

        def pick(cands, srcs):
            stacked = jnp.stack(cands)
            a = jnp.argmax(stacked)
            return stacked[a], jnp.asarray(srcs, dtype=jnp.int8)[a]

        vN, bN = pick([v[N], v[C2] + xb], (N, C2))
        vC0, b0 = pick([v[N] + eb, v[C2], v[C1] + dele, v[I2]], (N, C2, C1, I2))
        vC1, b1 = pick([v[C0], v[C2] + dele, v[I0]], (C0, C2, I0))
        vC2, b2 = pick([v[C1], v[C0] + dele, v[I1]], (C1, C0, I1))
        vC2 = vC2 + ce
        vI0, b4 = pick([v[C0] + inso, v[I0] + inse], (C0, I0))
        vI1, b5 = pick([v[C1] + inso, v[I1] + inse], (C1, I1))
        vI2, b6 = pick([v[C2] + inso, v[I2] + inse], (C2, I2))

        new_v = jnp.stack([vN, vC0, vC1, vC2, vI0, vI1, vI2])
        new_v = jnp.maximum(new_v, NEG)
        new_v = new_v - jnp.max(new_v)  # renormalise: scores stay bounded
        bp = jnp.stack([bN, b0, b1, b2, b4, b5, b6])
        return new_v, bp

    v0 = jnp.full((7,), NEG).at[N].set(0.0)
    v_last, bps = jax.lax.scan(step, v0, (codemit, entry_b, exit_b))

    # The backtrace carry must be int32: an int8 index inside lax.scan
    # (``bp[state]`` with int8 ``state``) miscompiles on current XLA:CPU —
    # the gather silently returns wrong rows past ~128 iterations.
    last_state = jnp.argmax(v_last).astype(jnp.int32)

    def back(state, bp):
        prev = bp[state].astype(jnp.int32)
        return prev, state

    _, states_rev = jax.lax.scan(back, last_state, bps, reverse=True)
    return states_rev.astype(jnp.int8)


def _strand_genes(
    codes: np.ndarray, params: GeneHmmParams, min_codons: int
) -> list[tuple[int, int, bytes]]:
    r"""Decode one strand; returns (start, end, corrected translation) with
    coordinates on this strand's orientation.  ``end`` INCLUDES a directly
    following in-frame stop codon when present (the six-frame Orf
    convention); the translation never includes the stop."""
    L = len(codes)
    if L < 3:
        return []
    c = codes.astype(np.int64)
    valid3 = np.zeros(L, dtype=bool)
    cod_id = np.zeros(L, dtype=np.int64)
    if L >= 3:
        v = (c[:-2] < 4) & (c[1:-1] < 4) & (c[2:] < 4)
        valid3[: L - 2] = v
        cod_id[: L - 2] = np.where(v, c[:-2] * 16 + c[1:-1] * 4 + c[2:], 0)

    is_stop = valid3 & np.isin(cod_id, STOP_IDS)
    is_start = valid3 & np.isin(cod_id, TABLE11_START_IDS)
    lo = np.where(valid3, params.codon_logodds[cod_id] + params.coding_bonus, -BIG)

    # codemit[i]: codon completed AT i (starts at i-2).
    codemit = np.full(L, -BIG, dtype=np.float32)
    codemit[2:] = lo[:-2]
    entry_b = (params.entry + params.start_bonus * is_start).astype(np.float32)
    exit_b = np.where(is_stop, params.exit_stop, params.exit_other).astype(np.float32)

    import jax.numpy as jnp

    from kaptive_tpu.ops.minimizer import bucket_length

    # Pad to a shape bucket so the jitted Viterbi compiles once per size
    # class instead of once per distinct contig/strand length.  The pad tail
    # blocks NEW gene entry (entry = -BIG) but lets an in-flight coding path
    # continue for free (codon emission 0): every coding/indel state has a
    # zero-cost continuation through the pad, exactly as the unpadded decode
    # lets a contig-end-truncated gene end in a coding state at no charge —
    # so the optimum over the real prefix is preserved.  (A -BIG pad emission
    # would strand such paths and silently drop genes running into the
    # contig break; regression-tested in test_genefinder.py.)
    Lp = bucket_length(L, minimum=1 << 12)
    if Lp != L:
        codemit = np.concatenate([codemit, np.zeros(Lp - L, np.float32)])
        entry_b = np.concatenate([entry_b, np.full(Lp - L, -BIG, np.float32)])
        exit_b = np.concatenate(
            [exit_b, np.full(Lp - L, params.exit_other, np.float32)]
        )
    states = np.asarray(
        _viterbi_states(
            jnp.asarray(codemit), jnp.asarray(entry_b), jnp.asarray(exit_b),
            indel=params.indel, ins_extend=params.ins_extend,
        )
    )[:L]

    coding = states != N
    if not coding.any():
        return []
    # Maximal coding runs (vectorised edge detection).
    d = np.diff(coding.astype(np.int8))
    run_starts = np.flatnonzero(d == 1) + 1
    run_ends = np.flatnonzero(d == -1) + 1
    if coding[0]:
        run_starts = np.concatenate(([0], run_starts))
    if coding[-1]:
        run_ends = np.concatenate((run_ends, [L]))
    run_bounds = list(zip(run_starts, run_ends))

    genes = []
    for s, e in run_bounds:
        seg_states = states[s:e]
        c_mask = (seg_states >= C0) & (seg_states <= C2)
        n_coding = int(c_mask.sum())
        if n_coding < 3 * min_codons:
            continue
        # Frame-corrected nucleotide stream: keep bases consumed in C states;
        # restore each deletion (phase skip C_p -> C_{(p+2)%3}) as one 'N'.
        # ``orig``: genomic position of each corrected base (deleted
        # placeholders borrow the following base's position).
        pos = np.flatnonzero(c_mask)
        phases = seg_states[pos] - C0
        corrected: list[int] = []
        orig: list[int] = []
        for idx, p in enumerate(pos):
            if idx > 0 and phases[idx] == (phases[idx - 1] + 2) % 3:
                corrected.append(4)  # deleted base placeholder
                orig.append(s + int(p))
            corrected.append(int(codes[s + p]))
            orig.append(s + int(p))
        arr = np.array(corrected, dtype=np.uint8)
        # Refine the gene start to the first table-11 start codon within the
        # leading 30 codons of the corrected frame (FragGeneScan-style start
        # refinement; partial/edge genes without one keep the raw boundary).
        trim = 0
        max_scan = min(30, len(arr) // 3 - min_codons)
        for k in range(max(max_scan, 0)):
            cstart = arr[3 * k : 3 * k + 3]
            if (cstart < 4).all() and (
                cstart[0] * 16 + cstart[1] * 4 + cstart[2]
            ) in TABLE11_START_IDS:
                trim = 3 * k
                break
        arr = arr[trim:]
        gene_start = orig[trim] if trim < len(orig) else s + int(pos[0])
        n_cod = len(arr) // 3
        nt = b"ACGTN"
        nt_bytes = bytes(nt[b] for b in arr[: n_cod * 3])
        translation = bytes(
            BacterialTranslationTable.translate(np.frombuffer(nt_bytes, dtype=np.uint8))
        )
        end = s + int(pos[-1]) + 1
        # Include the terminating stop codon in the interval when present
        # (matching the six-frame Orf convention).
        if end + 3 <= L and is_stop[end] and (states[end] == N):
            end += 3
        genes.append((gene_start, end, translation))
    return genes


def find_genes_hmm(
    seq: bytes, params: GeneHmmParams | None = None, min_codons: int = 30
) -> list[Orf]:
    r"""HMM gene calling on both strands; forward-strand coordinates.

    Drop-in alternative to :func:`kaptive_tpu.bgc.orf.find_orfs` that keeps
    genes intact across 1-2 bp indels (see the module docstring and
    ``tests/test_genefinder.py`` for the measured recall matrix).
    """
    params = params or GeneHmmParams.uniform()
    n = len(seq)
    if n < 3 * min_codons:
        return []
    fwd = _DNA_LUT[np.frombuffer(seq, dtype=np.uint8)]
    rc_bytes = seq.translate(BacterialTranslationTable._COMP)[::-1]
    rc = _DNA_LUT[np.frombuffer(rc_bytes, dtype=np.uint8)]

    orfs: list[Orf] = []
    for strand, codes in ((1, fwd), (-1, rc)):
        for s, e, translation in _strand_genes(codes, params, min_codons):
            if strand == 1:
                orfs.append(Orf(s, e, 1, translation))
            else:
                orfs.append(Orf(n - e, n - s, -1, translation))
    orfs.sort(key=lambda o: (o.start, o.end))
    return orfs
