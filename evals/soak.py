"""Long-running engine-vs-oracle fuzz soak (CPU, idle-core background job).

Extends tests/test_fuzz.py's contract — serialized engine output must be
byte-identical to the host-oracle pipeline (pipeline/core.tidehunter_core)
— across many more seeds and across the round-3 device paths that the
fixed 5-case fuzz matrix cannot cover every combination of: device
seeding (TH_DEVICE_SEED=1, incl. minimizer w>1 two-pass + HPC), device
chaining (TH_DEVICE_CHAIN=1, windowed scan + host post), --polish, all
4 output formats, min_copy/min_frac/only_unit filters.

Usage: python evals/soak.py [--minutes 60] [--start-seed 1000]
Prints one line per divergence (seed + params) and a summary; exit code
equals the number of divergences.
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tidehunter_tpu.engine import Engine  # noqa: E402
from tidehunter_tpu.io.codec import decode  # noqa: E402
from tidehunter_tpu.io.fastx import FastxRecord  # noqa: E402
from tidehunter_tpu.io.output import write_read_output  # noqa: E402
from tidehunter_tpu.params import Params  # noqa: E402
from tidehunter_tpu.pipeline.core import tidehunter_core  # noqa: E402


def _random_read(rng):
    kind = rng.integers(0, 5)
    if kind == 0:   # pure random (usually no TR)
        return decode(rng.integers(0, 4, int(rng.integers(50, 800))
                                   ).astype(np.uint8))
    unit_len = int(rng.integers(30, 400))
    copies = int(rng.integers(2, 9))
    err = float(rng.choice([0.0, 0.05, 0.1, 0.15]))
    unit = rng.integers(0, 4, unit_len).astype(np.uint8)
    parts = [rng.integers(0, 4, int(rng.integers(0, 100))).astype(np.uint8)]
    for _ in range(copies):
        out = []
        for c in unit:
            r = rng.random()
            if r < err / 3:
                continue
            elif r < 2 * err / 3:
                out.extend([int(rng.integers(0, 4)), int(c)])
            elif r < err:
                out.append(int(rng.integers(0, 4)))
            else:
                out.append(int(c))
        parts.append(np.array(out, np.uint8))
    if kind == 4:   # homopolymer-rich flank (stresses HPC seeding)
        parts.append(np.repeat(rng.integers(0, 4), int(rng.integers(5, 120)))
                     .astype(np.uint8))
    parts.append(rng.integers(0, 4, int(rng.integers(0, 100))).astype(np.uint8))
    return decode(np.concatenate(parts))


def _serialize(reads, results, mtp):
    buf = io.StringIO()
    for rec, res in zip(reads, results):
        write_read_output(buf, rec.name, rec.seq, res, mtp)
    return buf.getvalue()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=60.0)
    ap.add_argument("--start-seed", type=int, default=1000)
    ap.add_argument("--reads", type=int, default=12)
    ap.add_argument("--stop-file", default=None,
                    help="exit early when this file contains --stop-pattern "
                         "(lets a background soak yield the core to a "
                         "higher-priority measurement run)")
    ap.add_argument("--stop-pattern", default="UP ")
    args = ap.parse_args(argv)

    def _should_stop() -> bool:
        if not args.stop_file:
            return False
        try:
            with open(args.stop_file) as fh:
                return args.stop_pattern in fh.read()
        except OSError:
            return False

    deadline = time.time() + args.minutes * 60
    seed = args.start_seed
    n_runs = 0
    fails = []
    engines = {}
    while time.time() < deadline and not _should_stop():
        rng = np.random.default_rng(seed)
        mtp = Params()
        mtp.out_fmt = int(rng.choice([1, 2, 3, 4]))
        mtp.w = int(rng.choice([1, 1, 1, 3, 5]))
        mtp.hpc = int(rng.choice([0, 0, 1]))
        mtp.min_copy = int(rng.choice([2, 2, 3]))
        mtp.only_unit = bool(rng.choice([False, False, True]))
        if rng.random() < 0.3:
            mtp.min_frac = 0.6
        if rng.random() < 0.2:
            mtp.only_longest = True
        if rng.random() < 0.2:
            mtp.min_len = int(rng.choice([50, 100]))
        mtp.polish = int(rng.choice([0, 0, 1]))
        dev_seed = bool(rng.choice([False, True]))
        dev_chain = bool(dev_seed and rng.choice([False, True]))
        os.environ["TH_DEVICE_SEED"] = "1" if dev_seed else "0"
        os.environ["TH_DEVICE_CHAIN"] = "1" if dev_chain else "0"

        reads = [
            FastxRecord(name=f"s{seed}_{i}", comment="",
                        seq=_random_read(rng))
            for i in range(args.reads)
        ]
        key = (mtp.w, mtp.hpc, mtp.polish)
        if key not in engines:
            engines[key] = Engine(mtp, platform="cpu")
        eng = engines[key]
        try:
            got = _serialize(reads, eng.process_chunk(reads, mtp), mtp)
            want = _serialize(
                reads, [tidehunter_core(r.seq, mtp) for r in reads], mtp
            )
        except Exception as exc:  # noqa: BLE001
            fails.append((seed, f"EXCEPTION {type(exc).__name__}: {exc}"))
            print(f"seed={seed} CRASH {exc!r} "
                  f"(fmt={mtp.out_fmt} w={mtp.w} hpc={mtp.hpc} "
                  f"dev_seed={dev_seed} dev_chain={dev_chain} "
                  f"polish={mtp.polish})", flush=True)
            seed += 1
            n_runs += 1
            continue
        if got != want:
            fails.append((seed, "DIVERGENCE"))
            print(f"seed={seed} DIVERGENCE "
                  f"(fmt={mtp.out_fmt} w={mtp.w} hpc={mtp.hpc} "
                  f"min_copy={mtp.min_copy} only_unit={mtp.only_unit} "
                  f"dev_seed={dev_seed} dev_chain={dev_chain} "
                  f"polish={mtp.polish})", flush=True)
        n_runs += 1
        seed += 1
        if n_runs % 25 == 0:
            print(f"# {n_runs} runs, {len(fails)} failures, "
                  f"seed cursor {seed}", flush=True)
    print(f"soak done: {n_runs} runs x {args.reads} reads, "
          f"{len(fails)} failures")
    return min(len(fails), 120)


if __name__ == "__main__":
    sys.exit(main())
