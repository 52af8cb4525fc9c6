"""Banded MSA kernel parity on CPU via the Pallas interpreter.

The `gpu` suite (tests/test_msa_device.py) checks the banded kernels on
the card; this test drives DeviceMSA.consensus_batch through the
interpreter (interpret=True) at banded rungs — W=128 at
T=256 and W=256 at T=384 (ladder rule: ops/poa_profile.band_ladder) —
and asserts bit-equality with the banded host mirror
(ops/poa_profile.banded_profile_consensus), the same contract the
hardware test pins (consensus bases AND coverage, reference
src/abpoa_cons.c:92-107).
"""

import numpy as np

from tidehunter_tpu.ops.poa_profile import band_ladder, banded_profile_consensus


def _mut(rng, u, err):
    out = []
    for c in u:
        r = rng.random()
        if r < err / 3:
            continue
        elif r < 2 * err / 3:
            out.extend([rng.integers(0, 4), c])
        elif r < err:
            out.append(rng.integers(0, 4))
        else:
            out.append(c)
    return np.array(out, np.uint8)


def test_banded_msa_interpret_parity():
    from tidehunter_tpu.ops import msa_device as MD

    rng = np.random.default_rng(11)
    regions = []
    # (a) two narrow-spread regions: bucket T=256, first rung W=128
    for _ in range(2):
        unit = rng.integers(0, 4, int(rng.integers(170, 190))).astype(np.uint8)
        units = [_mut(rng, unit, 0.08) for _ in range(4)]
        spread = max(map(len, units)) - min(map(len, units))
        assert band_ladder(256, spread)[0] == 128  # banded rung IS selected
        regions.append(units)
    # (b) wide-spread region: bucket T=384, rung W=256 (W=128 ineligible)
    unit = rng.integers(0, 4, 180).astype(np.uint8)
    units = [_mut(rng, unit, 0.08) for _ in range(3)]
    units.append(np.concatenate([unit, unit[:100]]).astype(np.uint8))
    spread = max(map(len, units)) - min(map(len, units))
    assert band_ladder(384, spread)[0] == 256
    regions.append(units)

    msa = MD.DeviceMSA(2, 4, 4, 2, gap_open2=24, gap_ext2=1, interpret=True)
    res = msa.consensus_batch(regions)
    for reg, got in zip(regions, res):
        want = banded_profile_consensus(
            reg, 2, 4, 4, 2, gap_open2=24, gap_ext2=1)
        assert got is not None
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
