"""Affine-gap pairwise alignment: ksw2-equivalent wavefront DP (NumPy oracle).

Re-derivation of the Suzuki-Kasahara difference recurrence exactly as the
reference's SIMD kernel evaluates it (reference ksw2/ksw2_extz2_sse.c:26-303),
vectorized over anti-diagonals with NumPy. This is both the host oracle used
for byte-parity testing and the shape blueprint for the GPU kernels
(ops/wavefront.py): the same wavefront runs there vectorized over the
anti-diagonal *and* a batch of alignment problems.

Scoring is the reference's hard-coded alignment model (reference
src/ksw2_align.c:11-17): match=+1, mismatch=-2, gap_open=2, gap_ext=1 on a
5-letter alphabet where any comparison against N scores -gap_ext (because
mat[m*m-1]==0 selects sc_N = -e, ksw2_extz2_sse.c:68).

Parity-critical behaviors reproduced:
  * gap left-alignment tie-breaking of the direction bytes
    (ksw2_extz2_sse.c:171-196): diagonal wins ties vs E, E wins ties vs F
  * cell clamping z <= mat[0] + 2*(q+e) (score-preserving, line 70)
  * the row-max scan order of the 32-bit H array, including its 4-lane SIMD
    artifacts, which decides max_t tie-breaks for extension alignment
    (ksw2_extz2_sse.c:224-260)
  * ksw_backtrack state machine with is_rot=1 (ksw2/ksw2.h:115-152)
"""

from __future__ import annotations

import numpy as np

# Reference scoring constants (src/ksw2_align.c:11)
MATCH_SC = 1
MIS_SC = -2
GAP_OPEN = 2   # q
GAP_EXT = 1    # e
SC_N = -GAP_EXT
QE = GAP_OPEN + GAP_EXT          # 3
QE2 = 2 * QE                     # 6
MAX_SC = MATCH_SC + QE2          # 7
NEG_INF = -0x40000000

# cigar ops
CMATCH, CINS, CDEL = 0, 1, 2


def _scores(target_codes: np.ndarray, query_codes_rt: np.ndarray) -> np.ndarray:
    """s[t] for one anti-diagonal: score of target[t] vs query[r-t]."""
    is_n = (target_codes == 4) | (query_codes_rt == 4)
    eq = target_codes == query_codes_rt
    return np.where(is_n, SC_N, np.where(eq, MATCH_SC, MIS_SC)).astype(np.int32)


def _row_max_scan(H: np.ndarray, st0: int, en0: int) -> tuple[int, int]:
    """Replicates the exact max/argmax scan of ksw2_extz2_sse.c:229-260.

    Init at (H[en0], en0); 4 SIMD lanes over [st0, en1) each tracking their
    first strict improvement; lanes combined in order; then a sequential
    remainder scan. Ties therefore resolve: en0 first, then lane-0-first
    among the vectorized range, then first-occurrence in the remainder.
    """
    max_H, max_t = int(H[en0]), en0
    en1 = st0 + (en0 - st0) // 4 * 4
    lane_best = [max_H] * 4
    lane_t = [max_t] * 4
    for i in range(4):
        vals = H[st0 + i : en1 : 4] if st0 + i < en1 else H[0:0]
        if vals.size:
            m = int(vals.max())
            if m > lane_best[i]:
                lane_best[i] = m
                lane_t[i] = st0 + 4 * int(np.argmax(vals)) + i
    for i in range(4):
        if max_H < lane_best[i]:
            max_H, max_t = lane_best[i], lane_t[i]
    if en1 < en0:
        vals = H[en1:en0]
        m = int(vals.max())
        if m > max_H:
            max_H, max_t = m, en1 + int(np.argmax(vals))
    return max_H, max_t


class ExtzResult:
    """Subset of ksw_extz_t consumed by the pipeline (ksw2/ksw2.h:69-80)."""

    __slots__ = ("score", "max", "max_q", "max_t", "cigar", "n_cigar")

    def __init__(self) -> None:
        self.score = NEG_INF
        self.max = 0
        self.max_q = -1
        self.max_t = -1
        self.cigar: list[tuple[int, int]] = []   # (length, op)
        self.n_cigar = 0


def extz(
    query: np.ndarray,
    target: np.ndarray,
    score_only: bool = False,
) -> ExtzResult:
    """Global/extension affine-gap DP over the full band (w=-1, zdrop off,
    end_bonus=0), gap left-aligned — the only configurations the reference
    ever uses (src/ksw2_align.c:117-173).

    query/target: uint8 code arrays (0..4). Returns score (global), running
    max (extension), and the cigar unless score_only.
    """
    q8 = np.asarray(query, dtype=np.int32)
    t8 = np.asarray(target, dtype=np.int32)
    qlen, tlen = len(q8), len(t8)
    res = ExtzResult()
    if qlen <= 0 or tlen <= 0:
        return res

    u = np.zeros(tlen, dtype=np.int32)
    v = np.zeros(tlen, dtype=np.int32)
    x = np.zeros(tlen, dtype=np.int32)
    y = np.zeros(tlen, dtype=np.int32)
    H = np.full(tlen, NEG_INF, dtype=np.int64)
    n_rows = qlen + tlen - 1
    p = None if score_only else np.zeros((n_rows, tlen), dtype=np.uint8)

    for r in range(n_rows):
        st0 = max(0, r - qlen + 1)
        en0 = min(tlen - 1, r)
        if en0 == r:  # boundary for the brand-new diagonal cell
            y[r] = 0
            u[r] = GAP_OPEN if r else 0
        t_idx = np.arange(st0, en0 + 1)
        s = _scores(t8[t_idx], q8[r - t_idx])

        # previous-row neighbors with shifted-in boundary at t==0
        if st0 == 0:
            ax = np.concatenate(([0], x[0:en0]))
            av = np.concatenate(([GAP_OPEN if r else 0], v[0:en0]))
        else:
            ax = x[st0 - 1 : en0]
            av = v[st0 - 1 : en0]
        a = ax + av
        b = y[t_idx] + u[t_idx]

        z = s + QE2
        d = (a > z).astype(np.uint8)                      # E beats H strictly
        z = np.maximum(z, a)
        d = np.where(b > z, np.uint8(2), d)               # F beats max strictly
        z = np.maximum(z, b)
        z = np.minimum(z, MAX_SC)

        u_new = z - av
        v_new = z - u[t_idx]
        z2 = z - GAP_OPEN
        a2 = a - z2
        b2 = b - z2
        x_new = np.maximum(a2, 0)
        y_new = np.maximum(b2, 0)
        if p is not None:
            d = d | np.where(a2 > 0, np.uint8(0x08), np.uint8(0))
            d = d | np.where(b2 > 0, np.uint8(0x10), np.uint8(0))
            p[r, st0 : en0 + 1] = d

        u[t_idx] = u_new
        v[t_idx] = v_new
        x[t_idx] = x_new
        y[t_idx] = y_new

        # 32-bit H recurrence (ksw2_extz2_sse.c:224-266)
        if r == 0:
            H[0] = v_new[0] - QE - QE
        else:
            h_en0 = (
                H[en0 - 1] + u_new[en0 - st0] - QE
                if en0 > 0
                else H[0] + v_new[0] - QE
            )
            if en0 > st0:
                H[st0:en0] += v_new[: en0 - st0] - QE
            H[en0] = h_en0
        max_H, max_t = _row_max_scan(H, st0, en0)
        if max_H > res.max:
            res.max = max_H
            res.max_t = max_t
            res.max_q = r - max_t
        if r == n_rows - 1 and en0 == tlen - 1:
            res.score = int(H[tlen - 1])

    if not score_only:
        res.cigar = _backtrack(p, tlen - 1, qlen - 1)
        res.n_cigar = len(res.cigar)
    return res


def _backtrack(p: np.ndarray, i0: int, j0: int) -> list[tuple[int, int]]:
    """ksw_backtrack with is_rot=1, full band (ksw2/ksw2.h:119-152).

    Returns cigar as [(length, op)] in left-to-right order; op 0=M 1=I 2=D.
    I consumes query, D consumes target (matching "MID" in the reference).
    """
    cigar: list[tuple[int, int]] = []

    def push(op: int, length: int) -> None:
        if cigar and cigar[-1][1] == op:
            cigar[-1] = (cigar[-1][0] + length, op)
        else:
            cigar.append((length, op))

    i, j, state = i0, j0, 0
    while i >= 0 and j >= 0:
        tmp = int(p[i + j, i])
        if state == 0:
            state = tmp & 7
        elif not (tmp >> (state + 2)) & 1:
            state = 0
        if state == 0:
            state = tmp & 7
        if state == 0:
            push(CMATCH, 1)
            i -= 1
            j -= 1
        elif state == 1:
            push(CDEL, 1)
            i -= 1
        else:
            push(CINS, 1)
            j -= 1
    if i >= 0:
        push(CDEL, i + 1)
    if j >= 0:
        push(CINS, j + 1)
    cigar.reverse()
    return cigar


# --- adapter-level API mirroring src/ksw2_align.c ---


def cigar_identity(
    cigar: list[tuple[int, int]], query: np.ndarray, target: np.ndarray
) -> int:
    """Count identical bases along M runs (ksw2_get_xid, src/ksw2_align.c:62-86)."""
    qi = ti = iden = 0
    for length, op in cigar:
        if op == CMATCH:
            iden += int(np.sum(query[qi : qi + length] == target[ti : ti + length]))
            qi += length
            ti += length
        elif op == CINS:
            qi += length
        else:
            ti += length
    return iden


def global_identity(query: np.ndarray, target: np.ndarray) -> int:
    """ksw2_global (src/ksw2_align.c:117-132): identity count only."""
    res = extz(query, target, score_only=False)
    return cigar_identity(res.cigar, query, target)


def global_with_cigar(
    query: np.ndarray, target: np.ndarray
) -> tuple[int, list[tuple[int, int]]]:
    """ksw2_global_with_cigar (src/ksw2_align.c:134-151)."""
    res = extz(query, target, score_only=False)
    return cigar_identity(res.cigar, query, target), res.cigar


def right_ext(query: np.ndarray, target: np.ndarray) -> tuple[int, int]:
    """ksw2_right_ext (src/ksw2_align.c:153-159): (max_q, max_t), score-only
    extension; max is only advanced by scores > 0."""
    res = extz(query, target, score_only=True)
    return res.max_q, res.max_t


def left_ext(query: np.ndarray, target: np.ndarray) -> tuple[int, int]:
    """ksw2_left_ext (src/ksw2_align.c:161-173): extension on reversed seqs."""
    res = extz(query[::-1], target[::-1], score_only=True)
    return res.max_q, res.max_t


def backtrack_left_end(
    cigar: list[tuple[int, int]], q_left_ext: int
) -> int:
    """Project a split point through the cigar from the right end
    (ksw2_backtrack_left_end, src/ksw2_align.c:88-115): walk the cigar
    backwards consuming q_left_ext query bases, return consumed target bases.
    """
    t_left_ext = 0
    q_remain = q_left_ext
    for length, op in reversed(cigar):
        if op == CMATCH:
            if length >= q_remain:
                return t_left_ext + q_remain
            t_left_ext += length
            q_remain -= length
        elif op == CINS:
            if length >= q_remain:
                return t_left_ext
            q_remain -= length
        else:  # CDEL
            t_left_ext += length
    if q_remain > 0:
        raise ValueError("unmatched cigar and q_left_ext")
    return t_left_ext
