"""Consensus-accuracy evaluation, following the reference paper's protocol.

The reference evaluated on simulated tandem-repeat long reads sweeping
error rate 0.13-0.20, unit size 100-3000 and copy number 2-20 with 1000
reads per config, scoring each called consensus against the true repeat
unit (reference simulation/README.md:17-43; the datasets themselves were
moved out of the repo, so this regenerates equivalent ones).

Scoring: a called consensus can start at any rotation of the true unit, so
identity is computed by infix (HW) alignment of the consensus against the
unit doubled (the same rotation-invariance trick the reference applies to
adapters, src/gen_cons.c:227-233):
    identity = 1 - edit_distance(cons, unit+unit infix) / len(cons)

Usage:
    python evals/accuracy.py [--reads N] [--device gpu|cpu|off] [--configs all]

Prints one line per config: detection rate (reads with >=1 consensus
call), mean/median consensus identity, and mean copy-number error.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from tidehunter_tpu.io.codec import decode  # noqa: E402
from tidehunter_tpu.io.fastx import FastxRecord  # noqa: E402
from tidehunter_tpu.ops.myers import align_hw  # noqa: E402
from tidehunter_tpu.params import Params  # noqa: E402


# (error rate, unit length, copy number) — the FULL 15-dataset paper
# protocol (reference simulation/README.md:17-41): copy_num sweep
# c∈{2,3,5,10,20} at e0.15/s1000, err_rate sweep e∈{0.13,0.15a,0.15b,
# 0.16,0.20} at s1000/c10 (0.15a/0.15b are two replicas — reproduced
# here with distinct seeds via the replica tag), repeat_size sweep
# s∈{100,500,1000,2000,3000} at e0.15/c10.
# Note (0.15, 1000, 2): two copies at 15% error diverge ~28% pairwise,
# near the default -e 0.25 partition acceptance (reference
# src/partition.c:205), so low detection there is reference-faithful —
# the "up to 20% error" capability (README.md:68-70) presumes more
# copies.
CONFIGS = [
    # copy_num/
    (0.15, 1000, 2),
    (0.15, 1000, 3),
    (0.15, 1000, 5),
    (0.15, 1000, 10),
    (0.15, 1000, 20),
    # err_rate/ (0.15a and 0.15b replicas: same params, different seed)
    (0.13, 1000, 10),
    (0.15, 1000, 10, "a"),
    (0.15, 1000, 10, "b"),
    (0.16, 1000, 10),
    (0.20, 1000, 10),
    # repeat_size/
    (0.15, 100, 10),
    (0.15, 500, 10),
    (0.15, 2000, 10),
    (0.15, 3000, 10),
]
# (0.15, 1000, 10) appears in all three reference folders; it is listed
# once per distinct seed (base + replicas a/b) = 15 datasets total.


def mutate(rng, unit: np.ndarray, err: float) -> np.ndarray:
    """Apply uniform substitution/insertion/deletion noise at rate err
    (split evenly, the reference simulator's model)."""
    out = []
    for c in unit:
        r = rng.random()
        if r < err / 3:
            continue                                  # deletion
        elif r < 2 * err / 3:
            out.append(int(rng.integers(0, 4)))       # insertion
            out.append(int(c))
        elif r < err:
            out.append(int(rng.integers(0, 4)))       # substitution
        else:
            out.append(int(c))
    return np.array(out, dtype=np.uint8)


def make_read(rng, err: float, unit_len: int, copies: int, flank: int = 100):
    unit = rng.integers(0, 4, unit_len).astype(np.uint8)
    parts = [rng.integers(0, 4, flank).astype(np.uint8)]
    for _ in range(copies):
        parts.append(mutate(rng, unit, err))
    parts.append(rng.integers(0, 4, flank).astype(np.uint8))
    return decode(np.concatenate(parts)), decode(unit)


def consensus_identity(cons: str, unit: str) -> float:
    """Rotation-invariant identity of a called consensus vs the true unit."""
    if not cons:
        return 0.0
    ed, _, _ = align_hw(cons, unit + unit, -1)
    return max(0.0, 1.0 - ed / len(cons))


def evaluate(n_reads: int, device: str, configs, msa: str = "profile") -> int:
    import os

    if msa == "graph":
        # graph-POA (ops/poa.py numpy spec, native/poax.c C walk) in place
        # of the production profile-POA — the fidelity comparison axis.
        # With a device the engine runs msa_mode='poa' so everything
        # except the MSA stays on the same (device) path as the profile
        # axis — the comparison isolates the MSA model.
        os.environ["TH_MSA"] = "graph"
    mtp = Params()
    if device in ("gpu", "cpu"):
        from tidehunter_tpu.engine import make_engine

        process = make_engine(
            mtp, platform=device,
            msa_mode="poa" if msa == "graph" else "profile")
    else:
        from tidehunter_tpu.pipeline.core import tidehunter_core

        def process(chunk, mtp):
            return [tidehunter_core(rec.seq, mtp) for rec in chunk]

    print(f"{'err':>5} {'unit':>5} {'copies':>6} | {'detect%':>8} "
          f"{'mean_id%':>8} {'med_id%':>8} {'cn_err':>6} {'reads/s':>8}")
    for cfg in configs:
        err, unit_len, copies = cfg[:3]
        tag = cfg[3] if len(cfg) > 3 else ""
        # str hash is PYTHONHASHSEED-salted; map the replica tag to an
        # int so seeds are stable across processes (base == round-2 seeds)
        seed_tuple = (err, unit_len, copies) + (
            (ord(tag),) if tag else ()
        )
        rng = np.random.default_rng(hash(seed_tuple) % 2**31)
        reads, units = [], []
        for i in range(n_reads):
            seq, unit = make_read(rng, err, unit_len, copies)
            reads.append(FastxRecord(name=f"r{i}", comment="", seq=seq))
            units.append(unit)
        t0 = time.perf_counter()
        results = process(reads, mtp)
        dt = time.perf_counter() - t0
        idens, cn_errs, detected = [], [], 0
        for res, unit in zip(results, units):
            recs = [r for r in res.records if not r.is_unit]
            if not recs:
                continue
            detected += 1
            best = max(recs, key=lambda r: r.end - r.start)
            idens.append(consensus_identity(best.seq, unit))
            cn_errs.append(abs(best.copy_num - copies))
        mean_id = 100 * float(np.mean(idens)) if idens else 0.0
        med_id = 100 * float(np.median(idens)) if idens else 0.0
        cn = float(np.mean(cn_errs)) if cn_errs else float("nan")
        print(f"{err:5.2f}{tag or ' '}{unit_len:5d} {copies:6d} | "
              f"{100 * detected / n_reads:8.1f} {mean_id:8.2f} "
              f"{med_id:8.2f} {cn:6.2f} {n_reads / dt:8.1f}",
              flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reads", type=int, default=50)
    ap.add_argument("--device", default="gpu", choices=["gpu", "cpu", "off"])
    ap.add_argument("--configs", default="all")
    ap.add_argument(
        "--msa", default="profile", choices=["profile", "graph"],
        help="graph = score the graph-POA (native/poax.c walk of the "
             "ops/poa.py spec) instead of the production profile-POA; "
             "all other stages stay on the same --device path",
    )
    args = ap.parse_args(argv)
    if args.configs == "all":
        configs = CONFIGS
    else:
        configs = []
        for c in args.configs.split(","):
            e, u, n = c.split(":")[:3]
            configs.append((float(e), int(u), int(n)) + tuple(c.split(":")[3:]))
    return evaluate(args.reads, args.device, configs, msa=args.msa)


if __name__ == "__main__":
    sys.exit(main())
