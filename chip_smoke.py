"""Smoke run of the whole pipeline on the GPU: the quickest proof that the
system still starts on the card.  Not a benchmark.

    python chip_smoke.py [--seed 0]      # one card
    python chip_smoke.py --cards 4       # the data-parallel path only

Everything runs in this one process, through the CLI entry point
(tidehunter_tpu.cli.main), on inputs generated from --seed:

  1. the card's name and power limit (nvidia-smi, a child without JAX);
  2. every kernel compiled for the card and compared with its NumPy
     oracle at every bucket (the `gpu` tests of tests/test_wavefront.py
     and tests/test_msa_device.py, run in this process);
  3. three read mixes end to end — A: 4,096 R2C2 reads (450 bp x 9 at
     10%, gzipped FASTQ, -f 2); B: 256 reads of 2-3 kb units x 2-3 at
     16% (-f 2); C: 512 full-length reads with 84/25 bp adapters
     (-5 -3 -F -f 3).  Each mix runs twice: the first run's extra time
     is set-up and compilation, the second is the run time;
  4. the records of the first 48/8/32 reads of A/B/C compared byte for
     byte with the host oracle (--device off).

--cards 4 runs only mix A on a 4-card 'dp' mesh, compared with a
single-card engine in the same process and with the host oracle.

Any failure raises.  The last line is one JSON object:
{"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")

# (name, reads, unit bp range, copies range, error, flank, CLI args,
#  reads compared with the host oracle)
MIXES = {
    "A": (4096, (450, 450), (9, 9), 0.10, 150, ["-f", "2"], 48),
    "B": (256, (2000, 3000), (2, 3), 0.16, 150, ["-f", "2"], 8),
    "C": (512, (300, 600), (3, 6), 0.10, 100, ["-F", "-f", "3"], 32),
}


def card_lines() -> list:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def make_inputs(seed: int, mixes) -> dict:
    """FASTQ.gz per mix (and the adapter FASTA files for C)."""
    import numpy as np

    from tidehunter_tpu.tools.synth import (
        random_seq, synth_full_length_read, synth_read)

    os.makedirs(WORK, exist_ok=True)
    rng = np.random.default_rng(seed)
    five, three = random_seq(rng, 84), random_seq(rng, 25)
    paths = {}
    for name in mixes:
        n, (lo, hi), (c_lo, c_hi), err, flank, _, _ = MIXES[name]
        reads = []
        for i in range(n):
            L = int(rng.integers(lo, hi + 1))
            copies = int(rng.integers(c_lo, c_hi + 1))
            if name == "C":
                seq = synth_full_length_read(rng, five, three, L, copies,
                                             err, flank)
            else:
                seq = synth_read(rng, L, copies, err, flank)
            reads.append((f"{name.lower()}{i}", seq))
        fq = os.path.join(WORK, f"mix{name}.fq.gz")
        with gzip.open(fq, "wt") as f:
            for rn, seq in reads:
                f.write(f"@{rn}\n{seq}\n+\n{'I' * len(seq)}\n")
        sub = os.path.join(WORK, f"mix{name}_head.fq")
        with open(sub, "w") as f:
            for rn, seq in reads[: MIXES[name][6]]:
                f.write(f"@{rn}\n{seq}\n+\n{'I' * len(seq)}\n")
        paths[name] = (fq, sub, [rn for rn, _ in reads[: MIXES[name][6]]])
    with open(os.path.join(WORK, "five.fa"), "w") as f:
        f.write(f">five\n{five}\n")
    with open(os.path.join(WORK, "three.fa"), "w") as f:
        f.write(f">three\n{three}\n")
    return paths


def cli_args(name: str) -> list:
    args = list(MIXES[name][5])
    if name == "C":
        args += ["-5", os.path.join(WORK, "five.fa"),
                 "-3", os.path.join(WORK, "three.fa")]
    return args


def run_cli(args: list, tag: str) -> tuple:
    """cli.main(args) -> (output text, metrics snapshot, wall seconds)."""
    from tidehunter_tpu import cli
    from tidehunter_tpu.utils.metrics import METRICS

    out = os.path.join(WORK, f"{tag}.out")
    met = os.path.join(WORK, f"{tag}.json")
    METRICS.reset()
    t0 = time.perf_counter()
    rc = cli.main(args + ["-o", out, "--metrics", met])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli.main exited {rc} for {tag}: {args}")
    with open(out) as f, open(met) as g:
        return f.read(), json.load(g), wall


def records_of(text: str, fmt_fastq: bool, names: list) -> str:
    """The output records of the given reads, in output order."""
    want = set(names)
    lines = text.splitlines(keepends=True)
    keep = []
    if fmt_fastq:
        for i in range(0, len(lines), 4):
            if lines[i][1:].split("_rep", 1)[0] in want:
                keep += lines[i:i + 4]
    else:
        keep = [ln for ln in lines if ln.split("\t", 1)[0] in want]
    return "".join(keep)


def mix_on_device(name: str, fq: str, mesh_note: str) -> tuple:
    """Cold and warm CLI runs of one mix; prints its smoke line."""
    import jax

    cold_text, _, cold = run_cli(cli_args(name) + [fq], f"{name}_cold")
    text, snap, warm = run_cli(cli_args(name) + [fq], f"{name}_warm")
    if text != cold_text:
        raise RuntimeError(f"mix {name}: two runs gave different records")
    n = MIXES[name][0]
    peak = max(d.memory_stats().get("peak_bytes_in_use", 0)
               for d in jax.local_devices())
    caps = {k: int(snap.get(k, 0))
            for k in ("host_cap_aln", "host_cap_msa", "msa_host")}
    print(f"phase 3 mix {name}{mesh_note}: reads={n} "
          f"records={int(snap['cons_records'])} "
          f"setup_compile_s={cold - warm:.3f} run_s={warm:.3f} "
          f"reads_per_s={n / warm:.1f} (smoke, not a benchmark) "
          f"peak_bytes_in_use_so_far={peak} host_caps={json.dumps(caps)}",
          flush=True)
    if caps["msa_host"]:
        raise RuntimeError(f"mix {name}: MSA left the device uncounted")
    return text


def check_oracle(name: str, sub: str, names: list, text: str) -> None:
    """Phase 4: the device records of the first reads == --device off."""
    fastq = "3" in MIXES[name][5]
    t0 = time.perf_counter()
    want, _, _ = run_cli(cli_args(name) + ["--device", "off", sub],
                         f"{name}_oracle")
    got = records_of(text, fastq, names)
    if got != want:
        raise RuntimeError(
            f"mix {name}: device records differ from --device off "
            f"on the first {len(names)} reads")
    print(f"phase 4 mix {name}: first {len(names)} reads, "
          f"{len(want)} bytes of records equal to --device off "
          f"({time.perf_counter() - t0:.1f} s of host oracle)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    args = ap.parse_args()

    cards = card_lines()                               # phase 1
    for ln in cards:
        print(f"phase 1 card: {ln}", flush=True)

    sys.path.insert(0, ROOT)
    os.environ.setdefault("JAX_PLATFORMS", "cuda,cpu")
    import jax

    from tidehunter_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if jax.default_backend() != "gpu":
        raise SystemExit("no GPU: JAX's backend is " + jax.default_backend())
    devs = jax.devices()
    if len(devs) < args.cards:
        raise SystemExit(f"--cards {args.cards} needs {args.cards} GPUs, "
                         f"found {len(devs)}")

    if args.cards == 4:
        paths = make_inputs(args.seed, ["A"])
        fq, sub, names = paths["A"]
        os.environ["TH_MESH"] = "4"
        meshed = mix_on_device("A", fq, " on a dp:4 mesh")
        os.environ["TH_MESH"] = "1"
        single = mix_on_device("A", fq, " on one card")
        if meshed != single:
            raise RuntimeError("4-card records differ from one card's")
        print("phase 3 mix A: dp:4 mesh records equal one card's "
              f"({len(meshed)} bytes)", flush=True)
        check_oracle("A", sub, names, meshed)
    else:
        os.environ["TH_MESH"] = "1"
        import pytest

        t0 = time.perf_counter()                       # phase 2
        rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu",
                          "--rootdir", ROOT,
                          os.path.join(ROOT, "tests", "test_wavefront.py"),
                          os.path.join(ROOT, "tests", "test_msa_device.py")])
        if rc != 0:
            raise RuntimeError(f"phase 2 kernel-vs-oracle tests failed "
                               f"(pytest exit {rc})")
        print(f"phase 2 kernels compiled and equal to their oracles at "
              f"every bucket ({time.perf_counter() - t0:.1f} s)", flush=True)
        t0 = time.perf_counter()
        paths = make_inputs(args.seed, list(MIXES))
        print(f"phase 3 inputs generated from seed {args.seed} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        texts = {name: mix_on_device(name, paths[name][0], "")
                 for name in MIXES}
        for name in MIXES:                              # phase 4
            _, sub, names = paths[name]
            check_oracle(name, sub, names, texts[name])

    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
