"""Full-pipeline reads/s on one GPU.

Workload: synthetic ONT-R2C2-style concatemer reads (~4.3 kb: 9 copies of
a 450 bp unit at 10% error between adapter-less flanks), the shape of the
reference's headline use case (README.md:62-70; BASELINE.json configs),
generated from --seed.

    python bench.py [--reads 1024] [--reps 3] [--seed 42]

Needs a GPU: with any other JAX backend it exits non-zero.  Prints the
card's name and power limit, per-rep rates and steady-state stage timers
on stderr, and ONE JSON line on stdout with the device it ran on.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"# card: {card}", file=sys.stderr)

    import jax

    from tidehunter_tpu.engine import make_engine
    from tidehunter_tpu.params import Params
    from tidehunter_tpu.pipeline import runner
    from tidehunter_tpu.tools.synth import synth_read
    from tidehunter_tpu.utils.compile_cache import enable_compile_cache
    from tidehunter_tpu.utils.metrics import METRICS

    enable_compile_cache()
    if jax.default_backend() != "gpu":
        print(f"no GPU: JAX's backend is {jax.default_backend()}",
              file=sys.stderr)
        return 1
    # the pipelined runner overlaps a host prepare thread with the
    # device-drive thread; a short switch interval keeps the drive
    # thread's device wakeups from waiting on the GIL
    sys.setswitchinterval(0.001)
    rng = np.random.default_rng(args.seed)
    with tempfile.NamedTemporaryFile(
            "w", suffix=".fa", delete=False,
            dir=os.path.dirname(os.path.abspath(__file__))) as fa:
        for i in range(args.reads):
            fa.write(f">r2c2_{i}\n{synth_read(rng)}\n")
    mtp = Params()
    mtp.chunk_read_n = max(64, args.reads // 2)
    os.environ.setdefault("TH_MESH", "1")     # one card
    engine = make_engine(mtp, platform="gpu")
    try:
        t0 = time.perf_counter()
        runner.run(fa.name, mtp, out=io.StringIO(), process_chunk=engine)
        setup_s = time.perf_counter() - t0      # includes every compile
        METRICS.reset()
        dts = []
        for _ in range(max(1, args.reps)):
            t0 = time.perf_counter()
            metrics = runner.run(fa.name, mtp, out=io.StringIO(),
                                 process_chunk=engine)
            dts.append(time.perf_counter() - t0)
    finally:
        os.unlink(fa.name)

    print(f"# reps: {' '.join(f'{args.reads / d:.1f}' for d in dts)} "
          f"reads/s; first run incl. compile {setup_s:.2f}s", file=sys.stderr)
    s = METRICS.snapshot()
    stages = [k for k in sorted(s) if k.startswith("time_")]
    print("# stages (all reps): " + " ".join(
        f"{k[5:-2]}={s[k]:.2f}s" for k in stages), file=sys.stderr)
    d = jax.devices()[0]
    print(json.dumps({
        "metric": "reads/s, synthetic ONT R2C2 4.3kb (450bp x9, 10% err), "
                  "full pipeline, one card",
        "value": round(args.reads / min(dts), 3),
        "unit": "reads/s",
        "median": round(args.reads / sorted(dts)[len(dts) // 2], 3),
        "cons_records": metrics.cons_records,
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices()), "card": card},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
