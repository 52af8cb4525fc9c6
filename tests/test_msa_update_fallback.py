"""update_step relayout branch agreement: the shift-accumulate loop
(kmax <= 64) and the take_along_axis gather fallback must be
bit-identical on the same inputs.  The production workloads never cross
the kmax threshold (insertions per round are ~err/3 * qlen), so without
this test the lax.cond's gather branch would be dead in CI.  Semantics
under test: ops_c is right-anchored compacted ops (msa_device.py
_dp_bt_kernel contract), forward step p at lane p + NP - nst."""

import numpy as np
import pytest

from tidehunter_tpu.ops.msa_device import (
    OP_D, OP_I, OP_M, _build_jits, _relayout_gather, _relayout_shift)


def _mk_inputs(rng, B, T, NP, n_ins):
    """Random profile + a step sequence with n_ins leading inserts (an
    I-heavy alignment drives kmax = n_ins past any threshold)."""
    counts = rng.integers(0, 80, (B, T, 5)).astype(np.int16)
    n_placed = np.full(B, 3, np.int32)
    lo, hi = T // 4, T - n_ins - 4
    assert lo < hi, "test shape too small for n_ins"
    ncol = rng.integers(lo, hi, B).astype(np.int32)
    overflow = np.zeros(B, bool)
    unit = rng.integers(0, 4, (B, T)).astype(np.int32)
    qlen = rng.integers(T // 2, T - 4, B).astype(np.int32)
    active = np.ones(B, bool)
    ops = np.full((B, NP), 3, np.uint8)  # lanes outside the path
    nst = np.zeros((B, 1), np.int32)
    for b in range(B):
        # path: n_ins inserts, then alternate M/D over the old columns
        path = [OP_I] * n_ins
        c = q = n_ins and 0
        q = n_ins  # inserts consumed q
        while c < ncol[b] and len(path) < T - 2:
            if q < qlen[b] and (len(path) % 3 != 2):
                path.append(OP_M)
                q += 1
            else:
                path.append(OP_D)
            c += 1
        nst[b, 0] = len(path)
        # right-anchored: forward step p lands at lane p + NP - nst
        ops[b, NP - len(path):] = path
    return (counts, n_placed, ncol, overflow, unit, qlen, active,
            ops, nst)


@pytest.mark.parametrize("n_ins", [2, 70])
def test_shift_and_gather_branches_agree(n_ins):
    import jax.numpy as jnp

    rng = np.random.default_rng(5 + n_ins)
    B, T, NP = 8, 256, 512
    args = _mk_inputs(rng, B, T, NP, n_ins)
    counts, n_placed, ncol, overflow, unit, qlen, active, ops, nst = args

    # the two relayouts on the update's own column map
    NPa = ops.shape[1]
    posT = np.arange(T)[None, :]
    src = np.clip(posT + (NPa - nst), 0, NPa - 1)
    op = np.take_along_axis(ops, src, axis=1).astype(np.int32)
    valid = (posT < nst) & active[:, None]
    consumes_c = valid & (op != OP_I)
    col = np.cumsum(consumes_c, axis=1)
    colz = np.clip(col - 1, 0, T - 1)
    kmap = np.where(consumes_c, posT - colz, 0)
    shift = _relayout_shift(jnp.asarray(counts), jnp.asarray(consumes_c),
                            jnp.asarray(kmap), jnp.int32(kmap.max()))
    gather = _relayout_gather(jnp.asarray(counts), jnp.asarray(consumes_c),
                              jnp.asarray(colz))
    np.testing.assert_array_equal(np.asarray(shift), np.asarray(gather))

    # update_step picks the shift loop at n_ins=2 and the gather at 70;
    # either way the new counts are the gathered layout plus the unit
    up = _build_jits(2, 4, 4, 2, 24, 1)[2]
    counts2 = np.asarray(up(*args)[0])
    consumes_q = valid & (op != OP_D)
    qp = np.cumsum(consumes_q, axis=1) - 1
    base = np.take_along_axis(unit, np.clip(qp, 0, T - 1), axis=1)
    add = np.zeros((B, T, 5), np.int16)
    bi, pi = np.nonzero(consumes_q)
    add[bi, pi, base[bi, pi]] += 1
    np.testing.assert_array_equal(counts2, np.asarray(gather) + add)
    assert (kmap.max() <= 64) == (n_ins == 2)
