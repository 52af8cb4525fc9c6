"""Dual-affine (convex) gap model on the profile-POA path.

The abPOA contract is gap cost min{O1 + g*E1, O2 + g*E2} (reference
src/abpoa_cons.c:15-20, README.md:154-157).  These tests verify the host
profile aligner against an independent brute-force Gotoh DP (no prefix
tricks): the produced path must be structurally valid and its cost must
equal the brute-force optimum; with track 2 disabled the dual path must
equal the single-affine path exactly.
"""

import numpy as np
import pytest

from tidehunter_tpu.ops.poa_profile import (
    NEG,
    SCALE,
    Profile,
    align_to_profile,
    banded_profile_consensus,
    profile_consensus,
)


def _brute_score(unit, sub, wdel1, wdel2, o1, e1, o2, e2):
    """Plain 5-matrix dual-affine DP; returns optimal score."""
    T = len(wdel1)
    Lq = len(unit)
    Oi1, Ei1, Od1 = SCALE * o1, SCALE * e1, SCALE * o1
    Oi2, Ei2, Od2 = SCALE * o2, SCALE * e2, SCALE * o2
    H = np.full((Lq + 1, T + 1), NEG, np.int64)
    E1 = np.full((Lq + 1, T + 1), NEG, np.int64)
    E2 = np.full((Lq + 1, T + 1), NEG, np.int64)
    F1 = np.full((Lq + 1, T + 1), NEG, np.int64)
    F2 = np.full((Lq + 1, T + 1), NEG, np.int64)
    H[0, 0] = 0
    for c in range(1, T + 1):
        F1[0, c] = max(H[0, c - 1] - Od1, F1[0, c - 1]) - wdel1[c - 1]
        F2[0, c] = max(H[0, c - 1] - Od2, F2[0, c - 1]) - wdel2[c - 1]
        H[0, c] = max(F1[0, c], F2[0, c])
    for j in range(1, Lq + 1):
        E1[j, 0] = max(H[j - 1, 0] - Oi1, E1[j - 1, 0]) - Ei1
        E2[j, 0] = max(H[j - 1, 0] - Oi2, E2[j - 1, 0]) - Ei2
        H[j, 0] = max(E1[j, 0], E2[j, 0])
        for c in range(1, T + 1):
            E1[j, c] = max(H[j - 1, c] - Oi1, E1[j - 1, c]) - Ei1
            E2[j, c] = max(H[j - 1, c] - Oi2, E2[j - 1, c]) - Ei2
            M = H[j - 1, c - 1] + sub[c - 1, unit[j - 1]]
            F1[j, c] = max(H[j, c - 1] - Od1, F1[j, c - 1]) - wdel1[c - 1]
            F2[j, c] = max(H[j, c - 1] - Od2, F2[j, c - 1]) - wdel2[c - 1]
            H[j, c] = max(M, E1[j, c], E2[j, c], F1[j, c], F2[j, c])
    return int(H[Lq, T])


def _path_cost(ops, unit, sub, wdel1, wdel2, o1, e1, o2, e2):
    """Score of a returned path under the convex model; also validates
    structure (every column consumed once, unit consumed in order)."""
    Oi1, Ei1, Od1 = SCALE * o1, SCALE * e1, SCALE * o1
    Oi2, Ei2, Od2 = SCALE * o2, SCALE * e2, SCALE * o2
    score = 0
    c_next = 0
    q_next = 0
    i = 0
    while i < len(ops):
        kind, col, qpos = ops[i]
        if kind == "M":
            assert col == c_next and qpos == q_next
            score += int(sub[col, unit[qpos]])
            c_next += 1
            q_next += 1
            i += 1
        elif kind == "I":
            g = 0
            while i < len(ops) and ops[i][0] == "I":
                assert ops[i][2] == q_next
                q_next += 1
                g += 1
                i += 1
            score -= min(Oi1 + g * Ei1, Oi2 + g * Ei2)
        else:
            w1 = w2 = 0
            while i < len(ops) and ops[i][0] == "D":
                assert ops[i][1] == c_next
                w1 += int(wdel1[c_next])
                w2 += int(wdel2[c_next])
                c_next += 1
                i += 1
            score -= min(Od1 + w1, Od2 + w2)
    assert c_next == len(wdel1) and q_next == len(unit)
    return score


@pytest.mark.parametrize("seed", range(8))
def test_dual_affine_path_is_optimal(seed):
    rng = np.random.default_rng(seed)
    o1, e1, o2, e2 = 4, 2, 24, 1
    # profile from a few noisy copies so occupancy weights are non-trivial
    p = int(rng.integers(20, 60))
    base = rng.integers(0, 4, p)
    prof = Profile(base.astype(np.int64))
    for _ in range(int(rng.integers(1, 4))):
        u = base.copy()
        mut = rng.random(p) < 0.15
        u = np.where(mut, rng.integers(0, 4, p), u)
        sub = prof.sub_scores(2, 4)
        w1 = prof.del_weights(e1)
        w2 = prof.del_weights(e2)
        ops = align_to_profile(u.astype(np.int64), sub, w1, 4, 2,
                               o2, e2, w2)
        prof.update(u.astype(np.int64), ops)

    sub = prof.sub_scores(2, 4)
    w1 = prof.del_weights(e1)
    w2 = prof.del_weights(e2)
    # query with a LONG deletion and a LONG insertion so track 2 matters
    u = np.concatenate([
        base[: p // 3],
        rng.integers(0, 4, int(rng.integers(0, 40))),   # long insertion
        base[2 * p // 3:],                              # long deletion
    ]).astype(np.int64)

    ops = align_to_profile(u, sub, w1, o1, e1, o2, e2, w2)
    want = _brute_score(u, sub, w1, w2, o1, e1, o2, e2)
    got = _path_cost(ops, u, sub, w1, w2, o1, e1, o2, e2)
    assert got == want


@pytest.mark.parametrize("seed", range(4))
def test_dual_equals_single_when_track2_disabled(seed):
    rng = np.random.default_rng(100 + seed)
    p = int(rng.integers(15, 50))
    prof = Profile(rng.integers(0, 4, p).astype(np.int64))
    u = rng.integers(0, 4, int(rng.integers(5, 70))).astype(np.int64)
    sub = prof.sub_scores(2, 4)
    w1 = prof.del_weights(2)
    single = align_to_profile(u, sub, w1, 4, 2)
    # track 2 so expensive it can never win (max run <= p + len(u))
    big_o = 4 + 2 * (p + len(u) + 2)
    w2 = prof.del_weights(2)
    dual = align_to_profile(u, sub, w1, 4, 2, big_o, 2, w2)
    assert dual == single


def test_profile_consensus_dual_affine_smoke():
    rng = np.random.default_rng(9)
    unit = rng.integers(0, 4, 80)
    units = []
    for _ in range(5):
        u = unit.copy()
        mut = rng.random(80) < 0.1
        u = np.where(mut, rng.integers(0, 4, 80), u)
        units.append(u.astype(np.uint8))
    cons, cov = profile_consensus(units, 2, 4, 4, 2,
                                  gap_open2=24, gap_ext2=1)
    assert len(cons) > 60
    assert np.mean(cons == unit[: len(cons)]) > 0.5


def test_device_msa_dual_affine_matches_host():
    """DeviceMSA (Pallas interpreter) == host profile_consensus under the
    convex gap model, including regions with long indels where track 2
    (O2=24, E2=1) wins over track 1 (O1=4, E1=2)."""
    from tidehunter_tpu.ops import msa_device as MD

    dm = MD.DeviceMSA(2, 4, 4, 2, gap_open2=24, gap_ext2=1, interpret=True)
    rng = np.random.default_rng(77)
    regions = []
    for _ in range(10):
        p = int(rng.integers(40, 90))
        unit = rng.integers(0, 4, p)
        us = []
        for _ in range(int(rng.integers(3, 6))):
            u = list(unit.copy())
            # point errors
            for k in range(p):
                if rng.random() < 0.06:
                    u[k] = int(rng.integers(0, 4))
            # occasionally a LONG indel so the convex track matters
            if rng.random() < 0.5:
                at = int(rng.integers(0, p))
                glen = int(rng.integers(15, 30))
                if rng.random() < 0.5:
                    u[at:at] = [int(x) for x in rng.integers(0, 4, glen)]
                else:
                    del u[at:at + glen]
            us.append(np.array(u, np.uint8))
        regions.append(us)
    got = dm.consensus_batch(regions)
    for reg, r in zip(regions, got):
        want = banded_profile_consensus(reg, 2, 4, 4, 2,
                                        gap_open2=24, gap_ext2=1)
        assert r is not None
        np.testing.assert_array_equal(r[0], want[0])
        np.testing.assert_array_equal(r[1], want[1])


def test_device_msa_single_affine_unchanged():
    """Default DeviceMSA (no O2/E2) still equals the single-affine host
    path bit-for-bit (track 2 is constructed strictly dominated)."""
    from tidehunter_tpu.ops import msa_device as MD

    dm = MD.DeviceMSA(2, 4, 4, 2, interpret=True)
    rng = np.random.default_rng(78)
    regions = []
    for _ in range(6):
        p = int(rng.integers(30, 70))
        unit = rng.integers(0, 4, p)
        us = []
        for _ in range(4):
            u = np.where(rng.random(p) < 0.1,
                         rng.integers(0, 4, p), unit)
            us.append(u.astype(np.uint8))
        regions.append(us)
    got = dm.consensus_batch(regions)
    for reg, r in zip(regions, got):
        want = profile_consensus(reg, 2, 4, 4, 2)
        np.testing.assert_array_equal(r[0], want[0])
        np.testing.assert_array_equal(r[1], want[1])


def test_device_msa_banded_matches_host():
    """Banded DeviceMSA == banded host mirror at a banded bucket,
    including a band-touching region that both sides retry through the
    full kernels (interpret mode; band lowered to the T=512 bucket so
    the CPU interpreter stays fast)."""
    from tidehunter_tpu.ops import msa_device as MD
    from tidehunter_tpu.ops.poa_profile import banded_profile_consensus

    dm = MD.DeviceMSA(2, 4, 4, 2, gap_open2=24, gap_ext2=1, interpret=True)
    rng = np.random.default_rng(99)
    regions = []
    for i in range(6):
        p = 400
        unit = rng.integers(0, 4, p)
        us = []
        for _ in range(4):
            u = list(unit.copy())
            for k in range(p):
                if rng.random() < 0.08:
                    u[k] = int(rng.integers(0, 4))
            if i == 0 and len(us) == 1:
                # force a band touch: a 200-base deletion drives |c-j|
                # to ~200 >= band(128) - 8
                del u[100:300]
            us.append(np.array(u, np.uint8))
        regions.append(us)
    got = dm.consensus_batch(regions)
    for reg, r in zip(regions, got):
        want = banded_profile_consensus(
            reg, 2, 4, 4, 2, gap_open2=24, gap_ext2=1)
        assert r is not None
        np.testing.assert_array_equal(r[0], want[0])
        np.testing.assert_array_equal(r[1], want[1])


def test_device_msa_banded_sliding_window():
    """T=1024 bucket: the band window actually slides — every shift row
    of the kernel executes. One region, interpret mode."""
    from tidehunter_tpu.ops import msa_device as MD
    from tidehunter_tpu.ops.poa_profile import banded_profile_consensus

    rng = np.random.default_rng(123)
    unit = rng.integers(0, 4, 800)
    us = []
    for _ in range(3):
        u = np.where(rng.random(800) < 0.08,
                     rng.integers(0, 4, 800), unit)
        us.append(u.astype(np.uint8))
    dm = MD.DeviceMSA(2, 4, 4, 2, gap_open2=24, gap_ext2=1, interpret=True)
    got = dm.consensus_batch([us])
    want = banded_profile_consensus(us, 2, 4, 4, 2,
                                    gap_open2=24, gap_ext2=1)
    assert got[0] is not None
    np.testing.assert_array_equal(got[0][0], want[0])
    np.testing.assert_array_equal(got[0][1], want[1])


def test_polish_recut_recovers_missing_unit():
    """At 3 copies the anchor walk yields only 2 units (no anchor starts
    past the last copy) and the reference's n<=2 fast path emits the
    first unit verbatim; --polish's recut adopts the boundary-extension
    span as an extra unit and rebuilds a real consensus."""
    import sys

    from tidehunter_tpu.io.codec import decode
    from tidehunter_tpu.ops.myers import align_hw
    from tidehunter_tpu.params import Params
    from tidehunter_tpu.pipeline.core import tidehunter_core

    rng = np.random.default_rng(17)
    unit = rng.integers(0, 4, 800).astype(np.uint8)

    def noisy():
        out = []
        for c in unit:
            r = rng.random()
            if r < 0.05:
                continue
            elif r < 0.10:
                out.append(int(rng.integers(0, 4)))
                out.append(int(c))
            elif r < 0.16:
                out.append(int(rng.integers(0, 4)))
            else:
                out.append(int(c))
        return np.array(out, np.uint8)

    parts = [rng.integers(0, 4, 80).astype(np.uint8)]
    for _ in range(3):
        parts.append(noisy())
    parts.append(rng.integers(0, 4, 80).astype(np.uint8))
    seq = decode(np.concatenate(parts))
    du = decode(np.concatenate([unit, unit]))

    def run(polish):
        mtp = Params()
        mtp.polish = polish
        res = tidehunter_core(seq, mtp)
        assert res.records
        rec = max(res.records, key=lambda r: r.cons_len)
        ed, _, _ = align_hw(rec.seq, du, k=-1)
        return len(rec.sub_pos), 1 - ed / len(rec.seq)

    n0, id0 = run(0)
    n1, id1 = run(1)
    assert n0 == 3          # 2 units: the reference-faithful outcome
    assert n1 >= 4          # recut adopted the extension span
    assert id1 > id0 + 0.02
    assert id1 > 0.90
