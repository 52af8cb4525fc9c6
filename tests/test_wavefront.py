"""Wavefront kernels (ops/wavefront.py) vs the NumPy oracle.

The forward-annotation 'global' variant and the accumulator-based 'ext'
variant must reproduce ops/ksw2.py exactly: identity counts, the
backtrack_left_end projection for every qle in [0, qlen], the extension
max with the reference's SIMD row-scan tie order, and the global score.
The DP is integer arithmetic throughout (no float and no matrix product),
so the tolerance is exact equality on every device.

Here the kernels run through the Pallas interpreter (interpret=True);
the `gpu` cases compile them for the card at every alignment bucket.
"""

import numpy as np
import pytest

from tidehunter_tpu.ops import ksw2


def _make_batch(rng, B, LQ, LT, sim):
    q = np.full((B, LQ), 4, np.uint8)
    t = np.full((B, LT), 4, np.uint8)
    qlen = np.ones(B, np.int32)
    tlen = np.ones(B, np.int32)
    qle = np.zeros(B, np.int32)
    oracle = []
    for b in range(B):
        m = int(rng.integers(1, LQ + 1))
        n = int(rng.integers(1, LT + 1))
        if b == 0:
            m, n = 1, 1
        if b == 1:
            m, n = LQ, 1
        if b == 2:
            m, n = 1, LT
        qs = rng.integers(0, 5, m).astype(np.uint8)
        ts = rng.integers(0, 5, n).astype(np.uint8)
        if sim and m <= n:
            ts[:m] = qs
        q[b, :m] = qs
        t[b, :n] = ts
        qlen[b], tlen[b] = m, n
        qle[b] = [0, m, int(rng.integers(0, m + 1))][b % 3]
        iden, cig = ksw2.global_with_cigar(qs, ts)
        tle = ksw2.backtrack_left_end(cig, int(qle[b]))
        rs = ksw2.extz(qs, ts, score_only=True)
        r = ksw2.extz(qs, ts)
        oracle.append((iden, tle, rs.max, rs.max_t, rs.max_q, r.score))
    return q, qlen, t, tlen, qle, oracle


def _check(q, qlen, t, tlen, qle, oracle, interpret):
    from tidehunter_tpu.ops import wavefront as WF

    giden, gtle = WF.global_batch(q, qlen, t, tlen, qle, interpret=interpret)
    mx, mt, mq, sc = WF.ext_batch(q, qlen, t, tlen, interpret=interpret)
    ionly, _z = WF.global_batch(q, qlen, t, tlen, qle, iden_only=True,
                                interpret=interpret)
    giden, gtle, mx, mt, mq, sc, ionly = map(
        np.asarray, (giden, gtle, mx, mt, mq, sc, ionly)
    )
    for b, o in enumerate(oracle):
        assert (giden[b], gtle[b]) == (o[0], o[1])
        assert ionly[b] == o[0]
        assert (mx[b], mt[b], mq[b], sc[b]) == (o[2], o[3], o[4], o[5])


def test_wavefront_interpret_smoke():
    """Interpret-mode run on CPU: the kernel-vs-oracle parity contract,
    including the 1x1, LQx1 and 1xLT edge problems."""
    rng = np.random.default_rng(7)
    _check(*_make_batch(rng, 8, 32, 32, True), interpret=True)


@pytest.mark.parametrize("LQ,LT,sim", [(20, 40, True), (40, 20, False)])
def test_wavefront_interpret_rectangular(LQ, LT, sim):
    """Query and target buckets differ (boundary extension's t up to 2q):
    the reversed-query window and the lane mask must track both."""
    rng = np.random.default_rng(LQ * 100 + LT)
    _check(*_make_batch(rng, 8, LQ, LT, sim), interpret=True)


def test_reversed_query_and_lanes():
    """zq[S + t] == q[r - t] with S = LQ + TL - 1 - r for every row of the
    DP, N (4) outside the query; lanes are powers of two >= 128."""
    import jax.numpy as jnp

    from tidehunter_tpu.ops import wavefront as WF

    assert [WF.lanes(n) for n in (1, 128, 129, 640, 8192)] == [
        128, 128, 256, 1024, 8192]
    LQ, TL = 5, 8
    q = np.array([[0, 1, 2, 3, 0]], np.uint8)
    zq = np.asarray(WF.reversed_query(jnp.asarray(q), TL))
    assert zq.shape == (1, LQ + 2 * TL - 1)
    for r in range(LQ + TL - 1):
        S = LQ + TL - 1 - r
        for t in range(TL):
            want = q[0, r - t] if 0 <= r - t < LQ else 4
            assert zq[0, S + t] == want


@pytest.mark.gpu
@pytest.mark.parametrize("T", [128, 256, 512, 1024, 2048, 4096, 8192])
def test_wavefront_matches_oracle(T):
    """Compiled for the card at each alignment bucket the engine uses."""
    rng = np.random.default_rng(T)
    B = 8 if T <= 1024 else 4
    _check(*_make_batch(rng, B, T, T, T % 2048 == 0), interpret=False)
