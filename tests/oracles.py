"""Sequential DP oracle used to validate the vectorised device kernels.

This is an independent cell-at-a-time implementation of the banded local
Smith-Waterman-Gotoh recurrence with the semantics documented in
``kaptive_tpu/ops/swg.py`` (band 2k+3 with zero-score border cells, local
reset, first-max-cell tracking, diag>D>I / open-on-tie traceback), matching
``/root/reference/src/kaptive/core/pairwise.py:395-584`` behaviour.
"""

import numpy as np

NEG_INF = -1_000_000_000


def banded_swg_oracle(seq1, seq2, matrix, k, gap_open, gap_extend, is_seeded=False, diag_offset=0):
    len1, len2 = len(seq1), len(seq2)
    rows, cols = len1 + 1, len2 + 1
    if is_seeded:
        k_local, offset = k, diag_offset
    else:
        k_local, offset = max(k, abs(len1 - len2) + 1), 0

    W = 2 * k_local + 3
    M = np.full((rows, W), NEG_INF, dtype=np.int64)
    I = np.full((rows, W), NEG_INF, dtype=np.int64)
    D = np.full((rows, W), NEG_INF, dtype=np.int64)
    tbM = np.full((rows, W), 3, dtype=np.int8)
    tbD = np.zeros((rows, W), dtype=np.int8)
    tbI = np.zeros((rows, W), dtype=np.int8)

    def jm_of(i, j):
        start = max(0, i - offset - k_local - 1)
        return j - start

    # Padded-band init: M=0 in band incl. one border column each side.
    for i in range(rows):
        jc = i - offset
        for j in range(max(0, jc - k_local - 1), min(cols, jc + k_local + 2)):
            M[i, jm_of(i, j)] = 0

    goe = gap_open + gap_extend
    best = 0
    bi = bj = 0
    for i in range(1, rows):
        jc = i - offset
        for j in range(max(1, jc - k_local), min(cols, jc + k_local + 1)):
            jm = jm_of(i, j)
            jm_top = jm_of(i - 1, j)
            d_open = M[i - 1, jm_top] - goe
            d_ext = D[i - 1, jm_top] - gap_extend
            if d_open >= d_ext:
                D[i, jm], tbD[i, jm] = d_open, 0
            else:
                D[i, jm], tbD[i, jm] = d_ext, 1

            jm_left = jm_of(i, j - 1)
            i_open = M[i, jm_left] - goe
            i_ext = I[i, jm_left] - gap_extend
            if i_open >= i_ext:
                I[i, jm], tbI[i, jm] = i_open, 0
            else:
                I[i, jm], tbI[i, jm] = i_ext, 2

            m_diag = M[i - 1, jm_of(i - 1, j - 1)] + matrix[seq1[i - 1], seq2[j - 1]]
            bestv, tb = m_diag, 0
            if D[i, jm] > bestv:
                bestv, tb = D[i, jm], 1
            if I[i, jm] > bestv:
                bestv, tb = I[i, jm], 2
            if bestv <= 0:
                M[i, jm], tbM[i, jm] = 0, 3
            else:
                M[i, jm], tbM[i, jm] = bestv, tb
                if bestv > best:
                    best, bi, bj = bestv, i, j

    # Traceback
    i, j = bi, bj
    matches = mismatches = gaps = state = 0
    ei, ej = i, j
    while i > 0 and j > 0:
        jm = jm_of(i, j)
        if state == 0:
            tb = tbM[i, jm]
            if tb == 3:
                break
            elif tb == 0:
                if seq1[i - 1] == seq2[j - 1]:
                    matches += 1
                else:
                    mismatches += 1
                i -= 1
                j -= 1
            else:
                state = tb
        elif state == 1:
            tb = tbD[i, jm]
            gaps += 1
            i -= 1
            if tb == 0:
                state = 0
        else:
            tb = tbI[i, jm]
            gaps += 1
            j -= 1
            if tb == 0:
                state = 0
    return dict(
        score=best, matches=matches, mismatches=mismatches, gaps=gaps,
        q_start=i, q_end=ei, t_start=j, t_end=ej,
    )
