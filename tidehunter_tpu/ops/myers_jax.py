"""Batched device Myers bit-parallel infix (HW) search — edlib-kernel
equivalent in plain XLA.

The reference vendors edlib (C++, 64-bit blocks) for adapter searches
(reference edlib/src/edlib.cpp:388-424 calculateBlock; only HW/LOC via
src/edlib_align.c:73-85).  The host oracle here is ops/myers.align_hw
(Python bigints); this module is its device counterpart: bit vectors live
in W static uint32 words per problem ([B, W] lanes), the column scan is a
``lax.scan`` over the padded target, and the multi-word carry/shift chains
are unrolled over W (adapters are <=128 bp; W in {1,2,3,4}).

Exact edlib tie semantics (ops/myers.py docstring):
  * end  = LEFTMOST target position achieving the minimum distance
  * start = from an SHW pass on reversed sequences over the prefix
    [0..end], taking the LAST position with the same distance
Both passes run as batched scans; results are bit-identical with
align_hw (tests/test_myers_jax.py).

The scan is int32-bitwise elementwise over [B] lanes — VPU-friendly and
~two dispatches per batch regardless of B, vs one Python bigint loop per
problem on the host.  Queries/targets must be ACGTN (any case); callers
fall back to the host oracle otherwise (ambiguity codes compare by
character equality there, which a 2-bit+N encoding cannot represent).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np

_OK = set("ACGTNacgtn")


def _encode5(s: str) -> np.ndarray:
    lut = np.full(256, 4, np.uint8)
    for i, c in enumerate("ACGT"):
        lut[ord(c)] = i
        lut[ord(c.lower())] = i
    return lut[np.frombuffer(s.encode("latin1"), np.uint8)]


def device_ok(*seqs: str) -> bool:
    return all(set(s) <= _OK for s in seqs)


@functools.partial(
    __import__("jax").jit, static_argnames=("W", "shw", "track_last_eq")
)
def _scan_batch(peq, tgt, m, W, shw, track_last_eq, best_in):
    """Batched multi-word Myers scan.

    peq: [B, 5, W] uint32 query bitmasks; tgt: [B, L] uint8 (5 = pad);
    m: [B] query lengths.  shw=False: HW (top row 0, track leftmost min);
    shw=True: SHW (top row = j, track LAST position where score ==
    best_in [B]).  Returns (best, pos) int32 [B].
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    B = tgt.shape[0]
    u1 = jnp.uint32(1)
    hw_word = (m - 1) // 32
    hw_bit = ((m - 1) % 32).astype(jnp.uint32)
    # per-word masks of valid query bits
    wmask = []
    for w in range(W):
        bits = jnp.clip(m - 32 * w, 0, 32)
        full = jnp.uint32(0xFFFFFFFF)
        # (1 << bits) - 1 without 1<<32 overflow
        mask_w = jnp.where(
            bits >= 32, full,
            (u1 << bits.astype(jnp.uint32)) - u1)
        wmask.append(jnp.where(bits > 0, mask_w, jnp.uint32(0)))
    wmask = jnp.stack(wmask, axis=1)                      # [B, W]

    pv0 = wmask
    mv0 = jnp.zeros((B, W), jnp.uint32)
    score0 = m.astype(jnp.int32)
    best0 = jnp.where(shw, best_in.astype(jnp.int32),
                      jnp.full((B,), 1 << 30, jnp.int32))
    pos0 = jnp.full((B,), -1, jnp.int32)

    def step(carry, tc):
        pv, mv, score, best, pos, j = carry
        live = tc < 5
        eq = jnp.take_along_axis(
            peq, jnp.minimum(tc, 4)[:, None, None].astype(jnp.int32)
            .repeat(W, axis=2), axis=1)[:, 0, :]          # [B, W]
        xv = eq | mv
        eqpv = eq & pv
        # multi-word addition (eq&pv) + pv with carry
        sums = []
        carry_add = jnp.zeros((B,), jnp.uint32)
        for w in range(W):
            t1 = eqpv[:, w] + pv[:, w]
            c1 = (t1 < pv[:, w]).astype(jnp.uint32)
            s = t1 + carry_add
            c2 = (s < t1).astype(jnp.uint32)
            sums.append(s)
            carry_add = c1 | c2
        summ = jnp.stack(sums, axis=1)
        xh = (summ ^ pv) | eq
        ph = mv | (~(xh | pv) & wmask)
        mh = pv & xh
        phb = (jnp.take_along_axis(ph, hw_word[:, None], axis=1)[:, 0]
               >> hw_bit) & u1
        mhb = (jnp.take_along_axis(mh, hw_word[:, None], axis=1)[:, 0]
               >> hw_bit) & u1
        score = score + jnp.where(
            live, phb.astype(jnp.int32) - mhb.astype(jnp.int32), 0)
        # shift ph/mh left by one across words; HW injects 0, SHW 1
        phs, mhs = [], []
        for w in range(W):
            lo_p = (ph[:, w - 1] >> 31) if w else jnp.where(
                shw, u1, jnp.uint32(0))
            lo_m = (mh[:, w - 1] >> 31) if w else jnp.uint32(0)
            phs.append(((ph[:, w] << 1) | lo_p) & wmask[:, w])
            mhs.append(((mh[:, w] << 1) | lo_m) & wmask[:, w])
        ph = jnp.stack(phs, axis=1)
        mh = jnp.stack(mhs, axis=1)
        pv_n = (mh | (~(xv | ph) & wmask))
        mv_n = ph & xv
        pv = jnp.where(live[:, None], pv_n, pv)
        mv = jnp.where(live[:, None], mv_n, mv)
        if track_last_eq:
            hit = live & (score == best)
            pos = jnp.where(hit, j, pos)                  # LAST equal
            best_n = best
        else:
            hit = live & (score < best)                   # LEFTMOST min
            best_n = jnp.where(hit, score, best)
            pos = jnp.where(hit, j, pos)
        return (pv, mv, score, best_n, pos, j + 1), None

    (pv, mv, score, best, pos, _), _ = lax.scan(
        step, (pv0, mv0, score0, best0, pos0, jnp.int32(0)),
        tgt.T.astype(jnp.int32))
    return best, pos


def hw_batch(
    queries: Sequence[str], targets: Sequence[str], ks: Sequence[int]
) -> List[Tuple[int, Optional[int], Optional[int]]]:
    """Batched align_hw: [(ed, start, end)] with the host oracle's exact
    semantics. Problems the device cannot represent (empty/non-ACGTN/
    query > 128 bp) resolve through the host oracle."""
    import jax.numpy as jnp

    from .myers import align_hw

    n = len(queries)
    out: List = [None] * n
    dev_idx = []
    for i in range(n):
        q, t = queries[i], targets[i]
        if (0 < len(q) <= 128 and len(t) > 0
                and device_ok(q, t)):
            dev_idx.append(i)
        else:
            out[i] = align_hw(q, t, ks[i])
    if not dev_idx:
        return out

    W = max(1, -(-max(len(queries[i]) for i in dev_idx) // 32))
    L = 1
    maxt = max(len(targets[i]) for i in dev_idx)
    while L < maxt:
        L *= 2
    L = max(L, 128)
    B = -(-len(dev_idx) // 8) * 8
    peq = np.zeros((B, 5, W), np.uint32)
    tgt = np.full((B, L), 5, np.uint8)
    m = np.ones(B, np.int32)
    for row, i in enumerate(dev_idx):
        qe = _encode5(queries[i])
        te = _encode5(targets[i])
        for pos_, code in enumerate(qe):
            peq[row, code, pos_ // 32] |= np.uint32(1) << np.uint32(
                pos_ % 32)
        tgt[row, : len(te)] = te
        m[row] = len(qe)

    best, end = _scan_batch(
        jnp.asarray(peq), jnp.asarray(tgt), jnp.asarray(m), W,
        False, False, jnp.zeros(B, jnp.int32))
    best = np.asarray(best)
    end = np.asarray(end)

    # second pass: SHW on reversed query vs reversed target prefix
    peq2 = np.zeros((B, 5, W), np.uint32)
    tgt2 = np.full((B, L), 5, np.uint8)
    for row, i in enumerate(dev_idx):
        k = ks[i]
        if k >= 0 and best[row] > k:
            continue
        qe = _encode5(queries[i])[::-1]
        te = _encode5(targets[i])[: end[row] + 1][::-1]
        for pos_, code in enumerate(qe):
            peq2[row, code, pos_ // 32] |= np.uint32(1) << np.uint32(
                pos_ % 32)
        tgt2[row, : len(te)] = te
    _, pos2 = _scan_batch(
        jnp.asarray(peq2), jnp.asarray(tgt2), jnp.asarray(m), W,
        True, True, jnp.asarray(best))
    pos2 = np.asarray(pos2)

    for row, i in enumerate(dev_idx):
        k = ks[i]
        if k >= 0 and best[row] > k:
            out[i] = (-1, None, None)
        else:
            out[i] = (int(best[row]), int(end[row] - pos2[row]),
                      int(end[row]))
    return out
