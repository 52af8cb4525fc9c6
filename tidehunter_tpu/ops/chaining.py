"""Tandem-repeat chaining DP (period finding).

Faithful oracle of the reference chainer (reference src/tandem_chain.c:290-404):
hits grouped by identical end position form a ragged 2-D DP grid; a pruned
quadratic DP connects compatible hits; the top-scoring cells are backtracked
into up to 1000 chains with overlap deduplication; each surviving chain's
representative (est_start, est_period) is its first cell
(set_start_period, tandem_chain.c:251-255).

Every pruning rule, tie-break and even the reference's selection-sort quirk
in sort_chain (tandem_chain.c:188-207, which can duplicate an index when
three or more live chains reorder) is reproduced so chain selection is
bit-identical.

The device path (ops/chaining_jax.py) re-expresses the DP as a masked
fixed-window predecessor scan over padded per-read hit matrices; this oracle
is its ground truth.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

NO_CON, REG_CON, SAME_CON, OVL_CON = 0, 1, 2, 3
TOP_N = 1000


def ilog2_32(v: int) -> int:
    """Floor log2 (reference LogTable256, tandem_chain.c:7-19); -1 for 0."""
    return v.bit_length() - 1


@dataclasses.dataclass
class Chain:
    cells: List[int]          # flat dp-cell indices, in chain order
    score: int = 0
    est_ch_i: int = 0
    est_period: int = 0
    est_start: int = 0


class DpGrid:
    """Flat storage of the ragged dp[end_group][hit] grid."""

    __slots__ = (
        "n",
        "tot_n",
        "group_ptr",
        "group_size",
        "group_of",
        "start",
        "end",
        "score",
        "from_idx",
        "tracked",
    )

    def __init__(self, ends: np.ndarray, periods: np.ndarray, k: int) -> None:
        self.n = len(ends)
        # group by identical end (hits arrive sorted by end, then period)
        new_grp = np.empty(self.n, dtype=bool)
        new_grp[0] = True
        new_grp[1:] = ends[1:] != ends[:-1]
        self.group_of = np.cumsum(new_grp) - 1
        self.tot_n = int(self.group_of[-1]) + 1
        self.group_ptr = np.nonzero(new_grp)[0]
        self.group_size = np.diff(np.append(self.group_ptr, self.n))
        self.end = ends.astype(np.int64)
        self.start = (ends - periods).astype(np.int64)
        # init score = k + min(k, period)  (init_dp, tandem_chain.c:113-126)
        self.score = (k + np.minimum(k, periods)).astype(np.int64)
        self.from_idx = np.full(self.n, -1, dtype=np.int64)
        self.tracked = np.zeros(self.n, dtype=bool)

    def cell(self, flat: int) -> tuple[int, int, int]:
        """(start, end, score) of a flat cell."""
        return int(self.start[flat]), int(self.end[flat]), int(self.score[flat])


def _get_con_score(
    cur_start: int, cur_end: int, pre_start: int, pre_end: int, k: int
) -> Tuple[int, int]:
    """get_con_score (tandem_chain.c:151-166). Returns (con_res, con_score)."""
    cur_p = cur_end - cur_start
    pre_p = pre_end - pre_start
    if cur_start <= pre_start or cur_p >= pre_p * 1.8 or pre_p >= cur_p * 1.8:
        return NO_CON, 0
    dis1 = abs(cur_end - pre_end)
    dis2 = abs(cur_start - pre_start)
    matched = min(dis1, k) + min(dis2, k)
    delta_p = abs(cur_p - pre_p)
    gap_cost = (delta_p * delta_p) // 2 + ilog2_32(dis1 + dis2) // 2
    con_score = matched - gap_cost
    if delta_p == 0:
        return (OVL_CON if matched < 2 * k else SAME_CON), con_score
    return REG_CON, con_score


def _run_dp(dp: DpGrid, k: int) -> None:
    """Main pruned DP (tandem_chain.c:321-356)."""
    start, end, score, from_idx = dp.start, dp.end, dp.score, dp.from_idx
    group_ptr, group_size = dp.group_ptr, dp.group_size
    group_end = end[group_ptr]  # all cells in a group share the end
    for cur_i in range(1, dp.tot_n):
        gp = int(group_ptr[cur_i])
        for cur_j in range(int(group_size[cur_i])):
            cur = gp + cur_j
            cur_start = int(start[cur])
            cur_end = int(end[cur])
            max_score = int(score[cur])
            max_pre = -1
            max_h = cur_end - cur_start
            iter_n = 0
            stop = False
            for pre_i in range(cur_i - 1, -1, -1):
                if group_end[pre_i] < cur_start:
                    break
                gt = False
                pp = int(group_ptr[pre_i])
                for pre_j in range(int(group_size[pre_i])):
                    pre = pp + pre_j
                    con_res, con_score = _get_con_score(
                        cur_start, cur_end, int(start[pre]), int(end[pre]), k
                    )
                    if con_res == NO_CON:
                        continue
                    sc = int(score[pre]) + con_score
                    if sc > max_score:
                        max_score = sc
                        max_pre = pre
                        if con_res == SAME_CON or con_res == OVL_CON:
                            stop = True
                            break
                        gt = True
                    elif con_res == OVL_CON:
                        stop = True
                        break
                if stop:
                    break
                if gt:
                    iter_n = 0
                else:
                    iter_n += 1
                    if iter_n >= max_h:
                        break
            if max_score > int(score[cur]):
                score[cur] = max_score
                from_idx[cur] = max_pre


def _is_overlap_chain1(dp: DpGrid, ch1: Chain, ch2: Chain) -> bool:
    """is_overlap_chain1 (tandem_chain.c:54-65) — uses the START fields of
    the first and last cells of each chain."""
    s1 = int(dp.start[ch1.cells[0]])
    e1 = int(dp.start[ch1.cells[-1]])
    s2 = int(dp.start[ch2.cells[0]])
    e2 = int(dp.start[ch2.cells[-1]])
    mn = min(e1 - s1, e2 - s2)
    ovlp = min(e1, e2) - max(s1, s2)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.float64(ovlp) / np.float64(mn)
    return bool(ratio >= 0.5)


def _is_overlap_chain(dp: DpGrid, chains: List[Chain], ch_n: int) -> bool:
    """is_overlap_chain (tandem_chain.c:68-83): compare the new chain
    (chains[ch_n]) against existing chains in ARRAY order; may kill an
    existing lower-scoring chain in place."""
    new = chains[ch_n]
    if ch_n <= 0 or not new.cells:
        return False
    start = int(dp.start[new.cells[-1]])
    for i in range(ch_n - 1, -1, -1):
        ch = chains[i]
        if not ch.cells:
            continue
        if int(dp.end[ch.cells[-1]]) <= start:
            break
        if _is_overlap_chain1(dp, ch, new):
            if ch.score > new.score:
                return True
            ch.cells = []
            return False
    return False


def _backtrack_dp(dp: DpGrid, flat: int, chains: List[Chain], ch_n: int) -> bool:
    """backtrack_dp (tandem_chain.c:86-111)."""
    if dp.tracked[flat]:
        return False
    score = int(dp.score[flat])
    cur = flat
    cells = []
    while True:
        dp.tracked[cur] = True
        cells.append(cur)
        pre = int(dp.from_idx[cur])
        if pre == -1:
            break
        if dp.tracked[pre]:
            score -= int(dp.score[pre])
            break
        cur = pre
    cells.reverse()
    chains[ch_n] = Chain(cells=cells, score=score)
    return len(cells) > 1 and not _is_overlap_chain(dp, chains, ch_n)


def _is_in_chain(
    dp: DpGrid, chains: List[Chain], chain_idx: List[int], ch_n: int, flat: int
) -> bool:
    """is_in_chain (tandem_chain.c:170-185). cell_start is the start of the
    FIRST cell in the group; chains visited in chain_idx (end-desc) order."""
    grp = int(dp.group_of[flat])
    cell_start = int(dp.start[dp.group_ptr[grp]])
    cell_end = int(dp.end[flat])
    for _i in range(ch_n):
        ch = chains[chain_idx[_i]]
        if not ch.cells:
            continue
        chain_start = int(dp.start[ch.cells[0]])
        chain_end = int(dp.end[ch.cells[-1]])
        if chain_end < cell_start:
            return False
        if chain_start > cell_end:
            continue
        if cell_end - chain_start >= (chain_end - chain_start) // 2:
            return True
    return False


def _sort_chain(dp: DpGrid, chains: List[Chain], chain_idx: List[int], ch_n: int) -> None:
    """sort_chain (tandem_chain.c:188-207) — literal port, including the
    reference's index-duplication quirk when multiple swaps hit the same _i."""
    if ch_n < 2:
        return
    for _i in range(ch_n - 1):
        i = chain_idx[_i]
        if not chains[i].cells:
            continue
        ch_end1 = int(dp.end[chains[i].cells[-1]])
        for _j in range(_i + 1, ch_n):
            j = chain_idx[_j]
            if not chains[j].cells:
                continue
            ch_end2 = int(dp.end[chains[j].cells[-1]])
            if ch_end1 < ch_end2:
                chain_idx[_i] = j
                chain_idx[_j] = i
                ch_end1 = ch_end2


def tandem_chain(
    ends: np.ndarray, periods: np.ndarray, k: int
) -> Tuple[Optional[DpGrid], List[Chain]]:
    """Full chaining pass (tandem_chain, src/tandem_chain.c:290-404).

    Returns the dp grid and the post-processed chains in chain-end
    ascending order, each with est_* set from its first cell.
    """
    if len(ends) < 2:
        return None, []
    dp = DpGrid(ends, periods, k)
    _run_dp(dp, k)

    # rank all positive cells: collected (group desc, j asc), stable-sorted
    # by score desc (sort_dp_score, tandem_chain.c:32-43)
    order = []
    for i in range(dp.tot_n - 1, -1, -1):
        gp = int(dp.group_ptr[i])
        for j in range(int(dp.group_size[i])):
            if dp.score[gp + j] > 0:
                order.append(gp + j)
    order.sort(key=lambda f: -int(dp.score[f]))

    chains: List[Chain] = [Chain(cells=[]) for _ in range(TOP_N)]
    chain_idx = list(range(TOP_N))
    ch_n = 0
    for flat in order:
        if ch_n >= TOP_N:
            break
        if _is_in_chain(dp, chains, chain_idx, ch_n, flat):
            continue
        if _backtrack_dp(dp, flat, chains, ch_n):
            ch_n += 1
        _sort_chain(dp, chains, chain_idx, ch_n)

    # post-process (tandem_chain.c:391-400): reverse chain_idx order
    # (= chain end ascending), drop chains shorter than 3 cells
    post: List[Chain] = []
    for i in range(ch_n - 1, -1, -1):
        src = chains[chain_idx[i]]
        if len(src.cells) - 1 < 2:
            continue
        ch = Chain(cells=list(src.cells), score=src.score)
        first = ch.cells[0]
        ch.est_period = int(dp.end[first] - dp.start[first])
        ch.est_start = int(dp.start[first])
        ch.est_ch_i = 0
        post.append(ch)
    return dp, post
