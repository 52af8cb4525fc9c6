"""Unit partitioning: split a chained tandem-repeat region into unit copies.

Oracle of the reference's narrow-global-alignment partition walk
(get_partition_pos_with_narrow_global_alignment, reference
src/partition.c:171-276): starting from the chain's representative anchor
(est_start, est_start + est_period), walk the chain left then right; adjacent
anchors whose hits exactly abut split for free; otherwise globally align the
two flanking k-extended windows and project the split point through the
cigar (ksw2_backtrack_left_end). A rejected alignment (identity below
(1-max_div)*min(len)) inserts a -1 separator and restarts coordinates, so a
single chain can yield several TR regions.

The walk itself is written once as a GENERATOR (partition_walk) that yields
alignment requests ``(query, target, q_left_ext)`` and receives
``(iden_n, t_left_ext)``. The host oracle wrapper resolves each request with
ops/ksw2; the device engine drives many walks concurrently and resolves
whole rounds of requests with one batched kernel call per length bucket.
"""

from __future__ import annotations

from typing import Generator, List, Optional, Tuple

import numpy as np

from . import ksw2
from .chaining import Chain, DpGrid

AlignReq = Tuple[np.ndarray, np.ndarray, int]   # (query, target, q_left_ext)
AlignRes = Tuple[int, int]                       # (iden_n, t_left_ext)


def hoist_coords(dp: DpGrid, ch: Chain) -> Tuple[List[int], List[int]]:
    """Chain cell coordinates as plain-int lists: the walks below touch
    O(cells) entries and numpy scalar indexing costs ~1 us each — this
    was the single largest host cost per read. Callers driving both walk
    halves hoist once and share."""
    cells = np.asarray(ch.cells)
    return dp.start[cells].tolist(), dp.end[cells].tolist()


def partition_walk_left(
    bseq: np.ndarray,
    seq_len: int,
    dp: DpGrid,
    ch: Chain,
    k: int,
    max_div: float,
    coords: Optional[Tuple[List[int], List[int]]] = None,
) -> Generator[AlignReq, AlignRes, List[int]]:
    """Left half of the partition walk (partition.c:186-224); returns the
    positions found walking left of the representative anchor, in
    discovery order (caller reverses). Independent of the right half, so
    the engine drives both concurrently — halving the sequential depth of
    the chunk's partition stage."""
    est_ch_i = ch.est_ch_i
    est_start = ch.est_start
    est_period = ch.est_period
    starts, ends = coords if coords is not None else hoist_coords(dp, ch)
    first_end = ends[0]
    par_pos: List[int] = []

    ch_i, s, e = est_ch_i, est_start, est_start + est_period
    while s >= first_end and ch_i > 0:
        s2, e2 = s, e
        for i in range(ch_i - 1, -1, -1):
            s1 = starts[i]
            e1 = ends[i]
            if e1 == s:
                par_pos.append(s1)
                ch_i, s, e = i, s1, e1
                break
            elif e1 < s:
                # query = bseq[e1-k+1 .. e2] (len e2-e1+k), target likewise
                iden_n, t_left = yield (
                    bseq[e1 - k + 1 : e2 + 1],
                    bseq[s1 - k + 1 : s2 + 1],
                    e2 - s,
                )
                if iden_n >= min(s2 - s1 + k, e2 - e1 + k) * (1 - max_div):
                    e = s
                    s = s2 - t_left
                    if e == s:  # no backtrack progress
                        ch_i = 0
                        break
                    par_pos.append(s)
                    ch_i = i + 1
                else:  # skip this anchor: separator + restart
                    par_pos.append(-1)
                    par_pos.append(e1)
                    par_pos.append(s1)
                    ch_i, s, e = i, s1, e1
                break
            else:
                s2, e2 = s1, e1
    return par_pos


def partition_walk_right(
    bseq: np.ndarray,
    seq_len: int,
    dp: DpGrid,
    ch: Chain,
    k: int,
    max_div: float,
    coords: Optional[Tuple[List[int], List[int]]] = None,
) -> Generator[AlignReq, AlignRes, List[int]]:
    """Right half of the partition walk (partition.c:236-273)."""
    est_ch_i = ch.est_ch_i
    est_start = ch.est_start
    est_period = ch.est_period
    starts, ends = coords if coords is not None else hoist_coords(dp, ch)
    last_start = starts[-1]
    n_cells = len(starts)
    par_pos: List[int] = []

    ch_i, s, e = est_ch_i, est_start, est_start + est_period
    while ch_i < n_cells - 1 and e <= last_start:
        s1, e1 = s, e
        for i in range(ch_i + 1, n_cells):
            s2 = starts[i]
            e2 = ends[i]
            if s2 == e:
                par_pos.append(e2)
                ch_i, s, e = i, s2, e2
                break
            elif s2 > e:
                iden_n, t_left = yield (
                    bseq[s1 - k + 1 : s2 + 1],
                    bseq[e1 - k + 1 : e2 + 1],
                    s2 - e,
                )
                if iden_n >= min(s2 - s1 + k, e2 - e1 + k) * (1 - max_div):
                    s = e
                    e = e2 - t_left
                    if e == s:
                        ch_i = n_cells
                        break
                    par_pos.append(e)
                    ch_i = i - 1
                else:
                    par_pos.append(-1)
                    par_pos.append(s2)
                    par_pos.append(e2)
                    ch_i, s, e = i, s2, e2
                break
            else:
                s1, e1 = s2, e2
    return par_pos


def combine_walks(left: List[int], right: List[int], ch: Chain) -> List[int]:
    """Assemble the full par_pos from the two half-walk results."""
    return (
        list(reversed(left))
        + [ch.est_start, ch.est_start + ch.est_period]
        + right
    )


def partition_walk(
    bseq: np.ndarray,
    seq_len: int,
    dp: DpGrid,
    ch: Chain,
    k: int,
    max_div: float,
) -> Generator[AlignReq, AlignRes, List[int]]:
    """Full partition walk (left then right, sequential); returns par_pos.
    The engine uses the split halves directly to halve sequential depth."""
    left = yield from partition_walk_left(bseq, seq_len, dp, ch, k, max_div)
    right = yield from partition_walk_right(bseq, seq_len, dp, ch, k, max_div)
    return combine_walks(left, right, ch)


def _oracle_align(req: AlignReq) -> AlignRes:
    q, t, qle = req
    iden_n, cigar = ksw2.global_with_cigar(q, t)
    t_left = ksw2.backtrack_left_end(cigar, qle)
    return iden_n, t_left


def partition_positions(
    bseq: np.ndarray,
    seq_len: int,
    dp: DpGrid,
    ch: Chain,
    k: int,
    max_div: float,
    aligner=None,
) -> List[int]:
    """Synchronous wrapper resolving requests with the NumPy oracle (or an
    injected ``aligner(req) -> (iden_n, t_left_ext)``)."""
    align = aligner if aligner is not None else _oracle_align
    gen = partition_walk(bseq, seq_len, dp, ch, k, max_div)
    try:
        req = next(gen)
        while True:
            req = gen.send(align(req))
    except StopIteration as stop:
        return stop.value
