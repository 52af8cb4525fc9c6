"""Hand-written kernels on the card, at the bucket shapes chip_smoke.py
dispatches.

The wavefront global (with and without the t_left projection) and
extension kernels (ops/wavefront.py) are timed beside the plain-XLA form
of the same DP (ops/ksw2_jax.py) and checked against it and the NumPy
oracle; the fused profile-POA DP + backtrack (ops/msa_device.py) is timed
per consensus batch and checked against the host mirror
(ops/poa_profile.banded_profile_consensus).  Inputs are generated from
--seed.

    python evals/kernel_ab.py [--seed 0] [--reps 3]

Prints the card's name and power limit, one line per (kernel, shape) with
both times, and a JSON summary last.  Exits non-zero when no GPU is
present or any check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def mutate(rng, unit, err):
    out = []
    for c in unit:
        x = rng.random()
        if x < err / 3:
            continue
        if x < 2 * err / 3:
            out += [int(rng.integers(0, 4)), int(c)]
        elif x < err:
            out.append(int(rng.integers(0, 4)))
        else:
            out.append(int(c))
    return np.array(out, np.uint8)


def timed(fn, reps):
    import jax

    jax.block_until_ready(fn())             # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return min(ts)


def aln_case(rng, B, LQ, LT, err):
    q = np.full((B, LQ), 4, np.uint8)
    t = np.full((B, LT), 4, np.uint8)
    qlen = np.ones(B, np.int32)
    tlen = np.ones(B, np.int32)
    qle = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(max(1, LT // 2), LT - 8))
        ts = rng.integers(0, 4, n).astype(np.uint8)
        qs = mutate(rng, ts, err)[: LQ]
        q[b, :len(qs)] = qs
        t[b, :n] = ts
        qlen[b], tlen[b] = max(1, len(qs)), n
        qle[b] = int(rng.integers(0, qlen[b] + 1))
    return q, qlen, t, tlen, qle


def aln_ab(rng, reps, shapes):
    from tidehunter_tpu.ops import ksw2, ksw2_jax
    from tidehunter_tpu.ops import wavefront as WF

    rows = []
    for LQ, LT, B in shapes:
        q, qlen, t, tlen, qle = aln_case(rng, B, LQ, LT, 0.10)
        k_g = lambda: WF.global_batch(q, qlen, t, tlen, qle)        # noqa
        k_i = lambda: WF.global_batch(q, qlen, t, tlen, qle,        # noqa
                                      iden_only=True)
        k_e = lambda: WF.ext_batch(q, qlen, t, tlen)                # noqa
        p_g = lambda: ksw2_jax.extz_global_batch(q, qlen, t, tlen, qle)  # noqa
        p_e = lambda: ksw2_jax.extz_score_batch(q, qlen, t, tlen)   # noqa
        gi, gt = map(np.asarray, k_g())
        ii, _ = map(np.asarray, k_i())
        ke = [np.asarray(a) for a in k_e()]
        _, pi, pt = map(np.asarray, p_g())
        pe = [np.asarray(a) for a in p_e()]
        ok = (np.array_equal(gi, pi) and np.array_equal(gt, pt)
              and np.array_equal(ii, pi)
              and all(np.array_equal(a, b) for a, b in zip(ke, pe)))
        for b in range(min(B, 4)):
            qs, ts = q[b, :qlen[b]], t[b, :tlen[b]]
            iden, cig = ksw2.global_with_cigar(qs, ts)
            r = ksw2.extz(qs, ts, score_only=True)
            ok &= (int(gi[b]), int(gt[b])) == (
                iden, ksw2.backtrack_left_end(cig, int(qle[b])))
            ok &= (int(ke[0][b]), int(ke[1][b]), int(ke[2][b])) == (
                r.max, r.max_t, r.max_q)
        t_kg, t_ki, t_ke = (timed(f, reps) for f in (k_g, k_i, k_e))
        t_pg, t_pe = (timed(f, reps) for f in (p_g, p_e))
        row = dict(shape=[LQ, LT], B=B, ok=bool(ok),
                   global_kernel_s=t_kg, giden_kernel_s=t_ki,
                   global_plain_s=t_pg, ext_kernel_s=t_ke,
                   ext_plain_s=t_pe)
        print("aln", json.dumps(row), flush=True)
        rows.append(row)
    return rows


def msa_ab(rng, reps, cases):
    from tidehunter_tpu.ops.msa_device import DeviceMSA
    from tidehunter_tpu.ops.poa_profile import banded_profile_consensus

    rows = []
    for unit_len, n_units, err, n_regions in cases:
        regions = []
        for _ in range(n_regions):
            unit = rng.integers(0, 4, unit_len).astype(np.uint8)
            regions.append([mutate(rng, unit, err) for _ in range(n_units)])
        dm = DeviceMSA(2, 4, 4, 2, gap_open2=24, gap_ext2=1)
        out = dm.consensus_batch(regions)          # compile + warm
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = dm.consensus_batch(regions)
            ts.append(time.perf_counter() - t0)
        ok = True
        for ri in range(min(4, n_regions)):
            want = banded_profile_consensus(regions[ri], 2, 4, 4, 2,
                                            gap_open2=24, gap_ext2=1)
            got = out[ri]
            ok &= got is not None and np.array_equal(got[0], want[0]) \
                and np.array_equal(got[1], want[1])
        row = dict(unit_len=unit_len, units=n_units, err=err,
                   regions=n_regions, ok=bool(ok), kernel_s=min(ts))
        print("msa", json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    print("card:", card(), flush=True)
    import jax

    if jax.default_backend() != "gpu":
        print("no GPU backend", file=sys.stderr)
        return 1
    rng = np.random.default_rng(args.seed)
    # (LQ, LT, problems): aveMatch units of mix A, boundary extensions
    # (t up to 2q), and mix B's long units
    aln = aln_ab(rng, args.reps,
                 [(512, 512, 256), (512, 1024, 256), (1024, 1024, 128),
                  (4096, 4096, 16)])
    # (unit bp, units, error, regions): mix A (450 bp x 9 at 10%),
    # mix B (2-3 kb x 2-3 at 16%), and a banded mid-size bucket
    msa = msa_ab(rng, args.reps,
                 [(450, 9, 0.10, 256), (900, 4, 0.10, 64),
                  (2500, 3, 0.16, 16)])
    ok = all(r["ok"] for r in aln + msa)
    print(json.dumps({"ok": ok, "device": jax.devices()[0].device_kind,
                      "aln": aln, "msa": msa}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
