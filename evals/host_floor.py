"""Host-floor harness: run the full engine pipeline with an INSTANT device.

Replaces every BatchAligner device round and the DeviceMSA with host-side
stubs that return shape-correct answers at near-zero cost, so the measured
wall time is pure host orchestration: parse/encode/seed/chain/partition
walks/consensus generators/output. This is the per-read budget the host
burns no matter how fast the card is — the pipelined runner can only
hide device WAIT time, not host CPU time.

Usage: python evals/host_floor.py [n_reads] [--profile]
"""

from __future__ import annotations

import cProfile
import io
import pstats
import sys
import time

import numpy as np

sys.path.insert(0, __import__("os").path.dirname(
    __import__("os").path.dirname(__import__("os").path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

from tidehunter_tpu.tools.synth import synth_read  # noqa: E402
from tidehunter_tpu.io.fastx import FastxRecord  # noqa: E402
from tidehunter_tpu.params import Params  # noqa: E402
from tidehunter_tpu import engine as eng_mod  # noqa: E402
from tidehunter_tpu.pipeline import runner  # noqa: E402
from tidehunter_tpu.utils.metrics import METRICS  # noqa: E402


class InstantAligner:
    """Answers every request instantly with plausible values: global ->
    perfect identity at the midpoint, ext -> full spans. Downstream logic
    still runs (consensus, records, output) though outputs are garbage —
    only the host cost is being measured."""

    kernels = False
    host_aln_cap = 192   # sync native walk path reads this off the aligner

    def run_global(self, reqs, scores=None):
        return [
            (min(len(q), len(t)), max(0, len(t) - max(0, qle)))
            for q, t, qle in reqs
        ]

    def run_giden(self, reqs, scores=None):
        return [min(len(q), len(t)) for q, t in reqs]

    def run_ext(self, reqs, scores=None):
        return [(max(0, len(q) - 1), max(0, min(len(t), 2 * len(q)) - 1))
                for q, t in reqs]

    def run_ops(self, reqs, scores):
        out = []
        for q, t in reqs:
            n = max(len(q), len(t))
            out.append((np.zeros(n, np.int8), n))
        return out


class InstantMSA:
    def consensus_batch(self, regions):
        return [
            (r[0].copy(), np.full(len(r[0]), len(r), np.int32))
            for r in regions
        ]


def main() -> int:
    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    do_profile = "--profile" in sys.argv

    rng = np.random.default_rng(42)
    reads = [
        FastxRecord(name=f"r2c2_{i}", comment="", seq=synth_read(rng))
        for i in range(n_reads)
    ]
    mtp = Params()
    mtp.chunk_read_n = max(64, n_reads // 2)

    engine = eng_mod.Engine(mtp, platform="cpu")
    engine.aligner = InstantAligner()
    engine._device_msa = InstantMSA()
    engine.msa_mode = "profile"
    # the cpu engine would take the host MSA oracle: resolve 'msa' via
    # InstantMSA directly
    engine._resolve_msa = (
        lambda regions: engine._device_msa.consensus_batch(regions)
    )

    import tempfile
    fa = tempfile.NamedTemporaryFile("w", suffix=".fa", delete=False)
    for rec in reads:
        fa.write(f">{rec.name}\n{rec.seq}\n")
    fa.close()

    # warmup (imports, first-call setup)
    runner.run(fa.name, mtp, out=io.StringIO(), process_chunk=engine)
    METRICS.reset()

    prof = cProfile.Profile() if do_profile else None
    t0 = time.perf_counter()
    if prof:
        prof.enable()
    runner.run(fa.name, mtp, out=io.StringIO(), process_chunk=engine)
    if prof:
        prof.disable()
    dt = time.perf_counter() - t0

    print(f"host floor: {n_reads} reads in {dt:.2f}s = "
          f"{1e3 * dt / n_reads:.3f} ms/read ({n_reads / dt:.0f} reads/s)")
    s = METRICS.snapshot()
    for k in sorted(s):
        if k.startswith("time_"):
            print(f"  {k[5:-2]}: {1e3 * s[k] / n_reads:.3f} ms/read")
    if prof:
        st = pstats.Stats(prof)
        st.sort_stats("cumulative")
        st.print_stats(25)
    return 0


if __name__ == "__main__":
    sys.exit(main())
