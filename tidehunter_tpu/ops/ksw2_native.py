"""Native-backed small-window global alignment: same (iden_n, t_left_ext)
results as ops/ksw2.global_with_cigar + backtrack_left_end, C speed.

The partition walk's alignments are tiny (mean ~34 bp on the headline
workload) and strictly sequential per chain; resolving them host-side in C
removes every partition-stage device round trip. Parity with the NumPy oracle is pinned by
tests/test_ksw2_native.py.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..native import get_lib
from . import ksw2

__all__ = [
    "available",
    "global_tleft_batch",
    "global_tleft_one",
    "walk_right_native",
]

_fn = None
_fn1 = None
_checked = False


def available() -> bool:
    global _fn, _fn1, _checked
    if _checked:
        return _fn is not None
    _checked = True
    lib = get_lib()
    if lib is None or not hasattr(lib, "th_global_tleft_batch"):
        return False
    _fn = lib.th_global_tleft_batch
    _fn1 = lib.th_global_tleft
    return True


def global_tleft_one(q: np.ndarray, t: np.ndarray, qle: int) -> Tuple[int, int]:
    """Single-request fast path: ~5 us of glue (the batch entry's array
    packing costs ~50 us — more than the DP for walk-sized windows).
    Caller guarantees `available()` and contiguous uint8 inputs (bseq
    slices are).  The 20-bit pack requires len(t) + 1 < 2**20 — guaranteed
    by the engine's host_aln_cap clamp (engine.py)."""
    packed = _fn1(q.ctypes.data, len(q), t.ctypes.data, len(t), qle)
    if packed < 0:  # scratch allocation failed in C
        return _oracle_one(q, t, qle)
    return packed >> 20, (packed & 0xFFFFF) - 1


def global_tleft_batch(
    reqs: Sequence[Tuple[np.ndarray, np.ndarray, int]],
) -> List[Tuple[int, int]]:
    """[(q, t, q_left_ext)] -> [(iden_n, t_left_ext)], bit-exact with the
    oracle resolution ops/partition._oracle_align (and with the device
    wavefront kernel's qle > qlen rule)."""
    if not available():
        return [_oracle_one(q, t, qle) for q, t, qle in reqs]
    n = len(reqs)
    if n == 0:
        return []
    qoff = np.zeros(n, np.int64)
    qlen = np.zeros(n, np.int64)
    toff = np.zeros(n, np.int64)
    tlen = np.zeros(n, np.int64)
    qle = np.zeros(n, np.int64)
    qparts, tparts = [], []
    qo = to = 0
    for i, (q, t, e) in enumerate(reqs):
        q = np.ascontiguousarray(q, np.uint8)
        t = np.ascontiguousarray(t, np.uint8)
        qparts.append(q)
        tparts.append(t)
        qoff[i], qlen[i] = qo, len(q)
        toff[i], tlen[i] = to, len(t)
        qle[i] = e
        qo += len(q)
        to += len(t)
    qbuf = np.concatenate(qparts) if qo else np.zeros(1, np.uint8)
    tbuf = np.concatenate(tparts) if to else np.zeros(1, np.uint8)
    iden = np.zeros(n, np.int64)
    tleft = np.zeros(n, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    _fn(
        qbuf.ctypes.data_as(u8p), qoff.ctypes.data_as(i64p),
        qlen.ctypes.data_as(i64p),
        tbuf.ctypes.data_as(u8p), toff.ctypes.data_as(i64p),
        tlen.ctypes.data_as(i64p),
        qle.ctypes.data_as(i64p), ctypes.c_int64(n),
        iden.ctypes.data_as(i64p), tleft.ctypes.data_as(i64p),
    )
    return [
        (int(iden[i]), int(tleft[i])) if iden[i] >= 0
        # iden == -1: the C side could not allocate this item's scratch;
        # the NumPy oracle raises a catchable MemoryError instead
        else _oracle_one(*reqs[i])
        for i in range(n)
    ]


def walk_right_native(
    bseq: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
    est_start: int,
    est_period: int,
    k: int,
    max_div: float,
    cap: int,
) -> Optional[List[int]]:
    """Whole right-hand partition walk in C (alignments resolved inline).
    Returns the par_pos right-half list, or None when the walk must fall
    back to the generic generator path (oversize window / step or buffer
    cap). Bit-exact with ops/partition.partition_walk_right resolved by
    the oracle — pinned by tests/test_ksw2_native.py."""
    if not available():
        return None
    lib = get_lib()
    n = len(starts)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    bseq = np.ascontiguousarray(bseq, np.uint8)
    # real walks append ~10-20 positions; 4096 covers any plausible read
    # (a -1 overflow return falls back to the generator path, which is
    # exact at any size)
    out_cap = min(3 * (4 * n + 64), 4096)
    out = np.empty(out_cap, np.int64)
    got = lib.th_walk_right(
        bseq.ctypes.data, len(bseq),
        starts.ctypes.data, ends.ctypes.data, n,
        est_start, est_period, k, float(max_div), cap,
        out.ctypes.data, out_cap,
    )
    if got < 0:
        return None
    return out[:got].tolist()


def _oracle_one(q: np.ndarray, t: np.ndarray, qle: int) -> Tuple[int, int]:
    if len(q) == 0 or len(t) == 0:
        return 0, (len(t) if qle > len(q) else 0)
    if qle > len(q):
        iden, _ = ksw2.global_with_cigar(q, t)
        return iden, len(t)
    iden, cig = ksw2.global_with_cigar(q, t)
    return iden, ksw2.backtrack_left_end(cig, max(0, int(qle)))
