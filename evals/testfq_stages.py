"""Stage attribution for one FASTA/FASTQ file on the GPU: 1 warmup + N
reps, steady-state METRICS deltas per rep.

    python evals/testfq_stages.py reads.fq [reps]
"""
import io
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tidehunter_tpu.params import Params  # noqa: E402
from tidehunter_tpu.engine import make_engine  # noqa: E402
from tidehunter_tpu.pipeline import runner  # noqa: E402
from tidehunter_tpu.utils.metrics import METRICS  # noqa: E402

import jax  # noqa: E402

plat = jax.devices()[0].platform
print(f"[{time.ctime()}] device engine ready (platform={plat})", flush=True)

mtp = Params()
mtp.chunk_read_n = 100
engine = make_engine(mtp, platform="gpu")
testfq = sys.argv[1]
n_reads = sum(1 for _ in __import__(
    "tidehunter_tpu.io.fastx", fromlist=["read_fastx"]).read_fastx(testfq))

runner.run(testfq, mtp, out=io.StringIO(), process_chunk=engine)  # warmup
METRICS.reset()
prev = METRICS.snapshot()
for rep in range(int(sys.argv[2]) if len(sys.argv) > 2 else 3):
    t0 = time.perf_counter()
    runner.run(testfq, mtp, out=io.StringIO(), process_chunk=engine)
    dt = time.perf_counter() - t0
    cur = METRICS.snapshot()
    d = {k: cur.get(k, 0.0) - prev.get(k, 0.0) for k in cur}
    prev = cur
    stages = " ".join(
        f"{k[5:-2]}={d[k]:.2f}s" for k in sorted(d) if k.startswith("time_"))
    print(f"rep{rep}: {n_reads / dt:.1f} reads/s | {stages}", flush=True)
    print(
        f"   kernel_calls={d.get('rounds', 0):g} "
        f"wf_use={d.get('wf_cells', 0) / 1e6:.0f}M/"
        f"{d.get('wf_cells_disp', 0) / 1e6:.0f}M "
        f"msa_batches={d.get('msa_batches', 0):g} "
        f"retry_t={d.get('msa_retry_touch', 0):g} "
        f"retry_o={d.get('msa_retry_ovf', 0):g}",
        flush=True,
    )
