"""Partial-order-alignment consensus (abPOA-equivalent).

The reference links the external abPOA library (submodule URL only; sources
not vendored) and consumes this contract (reference src/abpoa_cons.c:12-120):
global MSA of the unit sequences of one tandem repeat under a convex
(dual-affine) gap model with scores match/mismatch/gap_open1,2/gap_ext1,2,
"row-column" majority-vote consensus, per-base coverage counts, an n<=2
verbatim fast path, a min-coverage rejection rule, and the sigmoid->phred
quality mapping.

This module re-derives partial order alignment from the published algorithm
(Lee, Grasso & Sharlow 2002; abPOA paper, Gao et al. 2021):

  * the graph holds one node per observed base; nodes aligned to each other
    form a column group (the RC-MSA columns)
  * each new unit is globally aligned to the graph by a DAG DP in
    topological order with two affine gap tracks (convex gap
    min{O1+g*E1, O2+g*E2}; cross-track gap splits are dominated because the
    convex cost is subadditive, so two independent Gotoh tracks are exact)
  * per-node rows are NumPy-vectorized over the sequence axis; insertion
    tracks use the prefix-max scan I(j) = max_{j'<j} (open(j') + j'*E) - O
    - j*E so no per-cell Python loop is needed
  * consensus: per MSA column, the most frequent base; the column is dropped
    when gaps outnumber the best base; coverage = #units whose row shows the
    consensus base at that column

The device path re-expresses unit-vs-profile alignment as device-resident
profile-POA kernels (ops/poa_profile.py on host, ops/msa_device.py on
device); this graph oracle is their ground truth.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

NEG = -(1 << 30)


class PoaGraph:
    def __init__(self, match: int, mismatch: int, o1: int, e1: int, o2: int, e2: int):
        self.match = match
        self.mismatch = mismatch
        self.o1, self.e1, self.o2, self.e2 = o1, e1, o2, e2
        self.base: List[int] = []          # node -> base code 0..4
        self.preds: List[List[int]] = []   # node -> predecessor node ids
        self.succs: List[List[int]] = []
        self.group: List[int] = []         # node -> column group id
        self.group_nodes: List[List[int]] = []
        self.end_nodes: set = set()        # last node of any sequence
        self.start_nodes: set = set()
        self.rows: List[List[Tuple[int, int]]] = []  # per seq: [(node, base)]

    # -- construction -----------------------------------------------------

    def _new_node(self, base: int, group: Optional[int] = None) -> int:
        nid = len(self.base)
        self.base.append(int(base))
        self.preds.append([])
        self.succs.append([])
        if group is None:
            group = len(self.group_nodes)
            self.group_nodes.append([])
        self.group.append(group)
        self.group_nodes[group].append(nid)
        return nid

    def _add_edge(self, u: int, v: int) -> None:
        if u < 0:
            return
        if v not in self.succs[u]:
            self.succs[u].append(v)
            self.preds[v].append(u)

    def add_first(self, seq: np.ndarray) -> None:
        prev = -1
        path = []
        for c in seq:
            nid = self._new_node(int(c))
            self._add_edge(prev, nid)
            prev = nid
            path.append((nid, int(c)))
        self.start_nodes.add(path[0][0])
        self.end_nodes.add(path[-1][0])
        self.rows.append(path)

    # -- alignment --------------------------------------------------------

    def _topo_order(self) -> List[int]:
        n = len(self.base)
        indeg = np.array([len(p) for p in self.preds], dtype=np.int64)
        order = []
        stack = [v for v in range(n) if indeg[v] == 0]
        stack.sort(reverse=True)
        while stack:
            v = stack.pop()
            order.append(v)
            for w in self.succs[v]:
                indeg[w] -= 1
                if indeg[w] == 0:
                    stack.append(w)
        return order

    def _gap_arr(self, L: int) -> np.ndarray:
        j = np.arange(L + 1, dtype=np.int64)
        g1 = self.o1 + j * self.e1
        g2 = self.o2 + j * self.e2
        g = -np.minimum(g1, g2)
        g[0] = 0
        return g

    def align(self, seq: np.ndarray):
        """Global alignment of seq to the graph. Returns the traceback as a
        list of (node_id_or_-1, seq_pos_or_-1) pairs: (v, j) match/mismatch,
        (v, -1) node deleted, (-1, j) base inserted."""
        L = len(seq)
        order = self._topo_order()
        n = len(self.base)
        rank = np.empty(n, dtype=np.int64)
        rank[order] = np.arange(n)
        src_row = self._gap_arr(L)
        neg_row = np.full(L + 1, NEG, dtype=np.int64)

        H = np.full((n, L + 1), NEG, dtype=np.int64)
        D1 = np.full((n, L + 1), NEG, dtype=np.int64)
        D2 = np.full((n, L + 1), NEG, dtype=np.int64)
        # backtrack stores
        bt_state = np.zeros((n, L + 1), dtype=np.int8)   # H sel: 0=M 1=D1 2=D2 3=I1 4=I2
        bt_ostate = np.zeros((n, L + 1), dtype=np.int8)  # O sel: 0=M 1=D1 2=D2
        bt_mpred = np.full((n, L + 1), -1, dtype=np.int32)
        bt_dcont = np.zeros((n, L + 1, 2), dtype=bool)   # D-track continuation
        bt_dpred = np.full((n, L + 1, 2), -1, dtype=np.int32)
        bt_iopen = np.full((n, L + 1, 2), -1, dtype=np.int32)  # I opener column

        seq_i = np.asarray(seq, dtype=np.int64)
        oe1, oe2 = self.o1 + self.e1, self.o2 + self.e2

        for v in order:
            bv = self.base[v]
            sub = np.where(seq_i == bv, self.match, -self.mismatch)
            preds = list(self.preds[v])
            if not preds or v in self.start_nodes:
                preds.append(-1)  # virtual source (abPOA's ABPOA_SRC_NODE)
            best_m = np.full(L, NEG, dtype=np.int64)
            best_mp = np.full(L, -1, dtype=np.int64)
            best_d1 = np.full(L + 1, NEG, dtype=np.int64)
            best_d1p = np.full(L + 1, -1, dtype=np.int64)
            best_d1c = np.zeros(L + 1, dtype=bool)
            best_d2 = np.full(L + 1, NEG, dtype=np.int64)
            best_d2p = np.full(L + 1, -1, dtype=np.int64)
            best_d2c = np.zeros(L + 1, dtype=bool)
            for u in preds:
                hu = src_row if u == -1 else H[u]
                m_cand = hu[:-1]
                upd = m_cand > best_m
                best_m = np.where(upd, m_cand, best_m)
                best_mp = np.where(upd, u, best_mp)
                d1_open = hu - oe1
                d1_cont = (D1[u] if u != -1 else neg_row) - self.e1
                cand = np.maximum(d1_open, d1_cont)
                upd = cand > best_d1
                best_d1 = np.where(upd, cand, best_d1)
                best_d1p = np.where(upd, u, best_d1p)
                best_d1c = np.where(upd, d1_cont > d1_open, best_d1c)
                d2_open = hu - oe2
                d2_cont = (D2[u] if u != -1 else neg_row) - self.e2
                cand = np.maximum(d2_open, d2_cont)
                upd = cand > best_d2
                best_d2 = np.where(upd, cand, best_d2)
                best_d2p = np.where(upd, u, best_d2p)
                best_d2c = np.where(upd, d2_cont > d2_open, best_d2c)

            Mrow = np.full(L + 1, NEG, dtype=np.int64)
            Mrow[1:] = best_m + sub
            ost = np.zeros(L + 1, dtype=np.int8)
            ost = np.where(best_d1 > Mrow, np.int8(1), ost)
            ost = np.where(best_d2 > np.maximum(Mrow, best_d1), np.int8(2), ost)
            O = np.maximum(Mrow, np.maximum(best_d1, best_d2))
            # insertion tracks via prefix-max scans over openers
            i1, i1_open = _ins_scan(O, oe1, self.e1)
            i2, i2_open = _ins_scan(O, oe2, self.e2)
            Hrow = np.maximum(O, np.maximum(i1, i2))
            st = ost.copy()
            st = np.where(i1 > O, np.int8(3), st)
            st = np.where(i2 > np.maximum(O, i1), np.int8(4), st)

            H[v] = Hrow
            D1[v] = best_d1
            D2[v] = best_d2
            bt_state[v] = st
            bt_ostate[v] = ost
            bt_mpred[v, 1:] = best_mp
            bt_dcont[v, :, 0] = best_d1c
            bt_dcont[v, :, 1] = best_d2c
            bt_dpred[v, :, 0] = best_d1p
            bt_dpred[v, :, 1] = best_d2p
            bt_iopen[v, :, 0] = i1_open
            bt_iopen[v, :, 1] = i2_open

        # pick end node (ties: earliest topological rank)
        ends = sorted(self.end_nodes)
        best_v = max(ends, key=lambda v: (H[v][L], -rank[v]))
        # backtrack: explicit (v, j, state) machine; state H re-dispatches
        # via bt_state, an insertion run lands on its opener via bt_ostate.
        path: List[Tuple[int, int]] = []
        v, j = best_v, L
        state = int(bt_state[v][j])
        done = False
        while not done:
            if state in (3, 4):  # insertion run: emit seq[j-1 .. jo]
                tr = state - 3
                jo = int(bt_iopen[v][j][tr])
                for jj in range(j - 1, jo - 1, -1):
                    path.append((-1, jj))
                j = jo
                state = int(bt_ostate[v][j])
                continue
            if state == 0:  # M: node v aligned to seq[j-1]
                path.append((v, j - 1))
                u = int(bt_mpred[v][j])
                j -= 1
                if u == -1:  # source: remaining prefix is leading insertions
                    for jj in range(j - 1, -1, -1):
                        path.append((-1, jj))
                    done = True
                else:
                    v = u
                    state = int(bt_state[v][j])
            else:  # deletion: skip node v
                tr = state - 1
                path.append((v, -1))
                cont = bool(bt_dcont[v][j][tr])
                u = int(bt_dpred[v][j][tr])
                if u == -1:
                    for jj in range(j - 1, -1, -1):
                        path.append((-1, jj))
                    done = True
                else:
                    v = u
                    state = state if cont else int(bt_state[v][j])
        path.reverse()
        return path

    # -- graph update -----------------------------------------------------

    def add_aligned(self, seq: np.ndarray, path) -> None:
        """Insert an aligned sequence into the graph (graph update step of
        POA: matched bases fuse with the aligned node's column group)."""
        prev = -1
        row: List[Tuple[int, int]] = []
        first = None
        for v, j in path:
            if j == -1:
                continue  # deleted node: sequence doesn't touch it
            c = int(seq[j])
            if v != -1:
                if self.base[v] == c:
                    node = v
                else:
                    node = -1
                    for w in self.group_nodes[self.group[v]]:
                        if self.base[w] == c:
                            node = w
                            break
                    if node == -1:
                        node = self._new_node(c, group=self.group[v])
            else:
                node = self._new_node(c)
            self._add_edge(prev, node)
            prev = node
            if first is None:
                first = node
            row.append((node, c))
        self.start_nodes.add(first)
        self.end_nodes.add(prev)
        self.rows.append(row)

    # -- MSA / consensus ---------------------------------------------------

    def msa_columns(self) -> List[int]:
        """Order column groups by longest-path layering of the group DAG."""
        ng = len(self.group_nodes)
        gsucc: List[set] = [set() for _ in range(ng)]
        gindeg = np.zeros(ng, dtype=np.int64)
        for u in range(len(self.base)):
            gu = self.group[u]
            for w in self.succs[u]:
                gw = self.group[w]
                if gw != gu and gw not in gsucc[gu]:
                    gsucc[gu].add(gw)
                    gindeg[gw] += 1
        layer = np.zeros(ng, dtype=np.int64)
        stack = sorted([g for g in range(ng) if gindeg[g] == 0], reverse=True)
        out = []
        while stack:
            g = stack.pop()
            out.append(g)
            for w in gsucc[g]:
                if layer[w] < layer[g] + 1:
                    layer[w] = layer[g] + 1
                gindeg[w] -= 1
                if gindeg[w] == 0:
                    stack.append(w)
        if len(out) < ng:  # cycle fallback: creation order
            out = list(range(ng))
            return out
        out.sort(key=lambda g: (layer[g], g))
        return out

    def consensus(self) -> Tuple[np.ndarray, np.ndarray]:
        """Row-column majority consensus (abPOA cons_agrm=1 contract,
        src/abpoa_cons.c:14). Returns (cons_bases, coverage)."""
        cols = self.msa_columns()
        col_rank = {g: i for i, g in enumerate(cols)}
        ncol = len(cols)
        nrow = len(self.rows)
        counts = np.zeros((ncol, 5), dtype=np.int64)
        for row in self.rows:
            for node, c in row:
                counts[col_rank[self.group[node]], c] += 1
        best = np.argmax(counts, axis=1)  # ties -> smaller base code
        best_cnt = counts[np.arange(ncol), best]
        gap_cnt = nrow - counts.sum(axis=1)
        keep = best_cnt > gap_cnt
        return best[keep].astype(np.uint8), best_cnt[keep].astype(np.int64)


def _ins_scan(openers: np.ndarray, oe: int, e: int) -> Tuple[np.ndarray, np.ndarray]:
    """I[j] = max_{j'<j} openers[j'] - oe - (j-j'-1)*e, with argmax opener.

    (gap of length g=j-j' costs oe + (g-1)*e = O + g*E.)
    """
    L1 = len(openers)
    j = np.arange(L1, dtype=np.int64)
    keyed = openers + j * e
    run_max = np.maximum.accumulate(keyed)
    # argmax of prefix (first occurrence)
    is_new = keyed >= run_max
    idx = np.where(is_new, j, -1)
    run_arg = np.maximum.accumulate(idx)
    I = np.full(L1, NEG, dtype=np.int64)
    I[1:] = run_max[:-1] - oe - (j[1:] - 1) * e
    opener = np.full(L1, -1, dtype=np.int64)
    opener[1:] = run_arg[:-1]
    return I, opener


def msa_consensus(
    units: List[np.ndarray],
    match: int,
    mismatch: int,
    gap_open1: int,
    gap_ext1: int,
    gap_open2: int,
    gap_ext2: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """POA MSA + majority consensus of unit sequences.

    Returns (cons_bases uint8, per-base coverage int64).

    Dispatches to the native C walk (native/poax.c, bit-exact with the
    NumPy implementation below — parity fuzz-pinned by
    tests/test_poa_native.py); set TH_POA_NATIVE=0 to force NumPy.
    """
    import os

    if os.environ.get("TH_POA_NATIVE", "1") != "0":
        res = _msa_consensus_native(
            units, match, mismatch, gap_open1, gap_ext1, gap_open2, gap_ext2)
        if res is not None:
            return res
    return msa_consensus_py(
        units, match, mismatch, gap_open1, gap_ext1, gap_open2, gap_ext2)


def _msa_consensus_native(units, match, mismatch, gap_open1, gap_ext1,
                          gap_open2, gap_ext2):
    import ctypes

    from .. import native

    lib = native.get_lib()
    if lib is None:
        return None
    lens = np.array([len(u) for u in units], dtype=np.int64)
    if len(lens) == 0 or (lens <= 0).any():
        return None
    seqs = np.concatenate(
        [np.ascontiguousarray(np.asarray(u, dtype=np.uint8)) for u in units])
    total = int(lens.sum())
    cons = np.empty(total, dtype=np.uint8)
    cov = np.empty(total, dtype=np.int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    n = lib.th_poa_msa(
        seqs.ctypes.data_as(u8p), lens.ctypes.data_as(i64p), len(lens),
        match, mismatch, gap_open1, gap_ext1, gap_open2, gap_ext2,
        cons.ctypes.data_as(u8p), cov.ctypes.data_as(i64p), total)
    if n < 0:
        return None
    return cons[:n].copy(), cov[:n].copy()


def msa_consensus_py(
    units: List[np.ndarray],
    match: int,
    mismatch: int,
    gap_open1: int,
    gap_ext1: int,
    gap_open2: int,
    gap_ext2: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """NumPy reference implementation (the behavioral spec of th_poa_msa)."""
    g = PoaGraph(match, mismatch, gap_open1, gap_ext1, gap_open2, gap_ext2)
    g.add_first(np.asarray(units[0], dtype=np.uint8))
    for u in units[1:]:
        u = np.asarray(u, dtype=np.uint8)
        path = g.align(u)
        g.add_aligned(u, path)
    return g.consensus()


def sigmoid_phred_qual(cov: np.ndarray, n_seqs: int) -> np.ndarray:
    """FASTQ quality chars (reference src/abpoa_cons.c:100-107):
    x = 13.8*(1.25*cov/n - 0.25); p = 1 - 1/(1+e^-x); q = 33 + int(-10*log10(p)+0.499)."""
    out = np.empty(len(cov), dtype=np.uint8)
    for i, c in enumerate(cov):
        x = 13.8 * (1.25 * int(c) / n_seqs - 0.25)
        p = 1.0 - 1.0 / (1.0 + math.exp(-x))
        out[i] = 33 + int(-10.0 * math.log10(p) + 0.499)
    return out
