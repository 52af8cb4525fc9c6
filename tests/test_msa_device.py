"""Device-resident profile-POA (ops/msa_device.py) vs the host oracle, on
the card.

Bit-exactness contract: ops/poa_profile.banded_profile_consensus, the host
mirror of the device driver (same buckets, band ladder and retries) —
consensus bases AND coverage; coverage feeds the -r filter and FASTQ
quals (reference src/abpoa_cons.c:92-107).  The DP is integer arithmetic
throughout, so the tolerance is exact equality.  These tests compile the
kernels for the card (`gpu` marker); tests/test_dual_affine.py runs the
same kernels through the Pallas interpreter on the CPU.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _mutate(rng, u, err):
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


def _check(regions, **kw):
    from tidehunter_tpu.ops.msa_device import DeviceMSA
    from tidehunter_tpu.ops.poa_profile import banded_profile_consensus

    dev = DeviceMSA(2, 4, 4, 2, gap_open2=24, gap_ext2=1, **kw
                    ).consensus_batch(regions)
    for ri, r in enumerate(dev):
        hb, hcov = banded_profile_consensus(regions[ri], 2, 4, 4, 2,
                                            gap_open2=24, gap_ext2=1, **kw)
        assert r is not None, f"region {ri} unexpectedly fell back"
        assert np.array_equal(r[0], hb), f"region {ri} bases differ"
        assert np.array_equal(r[1], hcov), f"region {ri} coverage differs"


# unit lengths whose 1.2x margin lands in each MSA bucket 128 .. 4096
_BUCKET_UNITS = {128: 90, 256: 190, 384: 300, 512: 400, 640: 510,
                 768: 610, 896: 720, 1024: 820, 2048: 1650, 4096: 3300}


@pytest.mark.parametrize("bucket", sorted(_BUCKET_UNITS))
@pytest.mark.parametrize("width", ["banded", "full"])
def test_device_msa_bit_exact_vs_host(bucket, width):
    """Each bucket, on its narrowest band rung and on the full-width
    kernel (one truncated unit spreads the lengths past every rung)."""
    rng = np.random.default_rng(bucket + (width == "full"))
    L = _BUCKET_UNITS[bucket]
    regions = []
    for _ in range(3):
        unit = rng.integers(0, 4, L).astype(np.uint8)
        units = [_mutate(rng, unit, 0.10) for _ in range(3)]
        if width == "full":
            units[1] = units[1][: max(8, len(units[1]) - 300)]
        regions.append(units)
    _check(regions)


def test_device_msa_polish_bit_exact_vs_host():
    rng = np.random.default_rng(11)
    regions = []
    for _ in range(12):
        L = int(rng.integers(20, 250))
        unit = rng.integers(0, 4, L).astype(np.uint8)
        regions.append([_mutate(rng, unit, 0.12)
                        for _ in range(int(rng.integers(3, 12)))])
    _check(regions, polish=1)


def test_device_msa_banded_bucket_hardware():
    """Banded (>=1024) buckets incl. the sliding window, the convex gap
    model, and a band-touching region retried through the full kernel."""
    rng = np.random.default_rng(31)
    regions = []
    for i in range(6):
        p = int(rng.integers(900, 1600))
        unit = rng.integers(0, 4, p)
        us = []
        for _ in range(4):
            u = list(np.where(rng.random(p) < 0.08,
                              rng.integers(0, 4, p), unit))
            if i == 0 and len(us) == 1:
                del u[100:420]  # force a band touch -> full retry
            us.append(np.array(u, np.uint8))
        regions.append(us)
    _check(regions)
