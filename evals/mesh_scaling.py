"""Virtual CPU-mesh weak-scaling curve: a rehearsal of the multi-card
path without cards.

It checks that the production mesh path's SHAPES and DISPATCH scale as
designed (the time on four cards comes from chip_smoke.py --cards 4).  It
runs the full engine (Pallas kernels through the interpreter) on a 1/2/4/8
virtual-device CPU mesh with FIXED PER-DEVICE WORK (weak scaling:
reads = 8 * n_devices) and reports wall time per config.  Flat wall time
= per-device work constant = the dp sharding divides batches instead of
duplicating them; the engine-vs-oracle bit-exactness of the same path is
covered by tests/test_multichip.py.

Interpret-mode kernels are far slower than the card and ALL virtual
devices share the host's cores, so wall time necessarily grows
with total work even under perfect sharding (the virtual devices execute
serially).  The signal is PER-READ wall time: if the mesh path duplicated
batches to every device instead of sharding them, per-read time would
grow ~linearly with n_devices; correct sharding keeps it flat (or
slightly falling as fixed per-dispatch costs amortize over more rows).

Runs each mesh size in a subprocess (the device count is fixed at
backend init).  Usage: python evals/mesh_scaling.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = r"""
import os, sys, time
import numpy as np
import jax

n = int(sys.argv[1])
reads_per_dev = int(sys.argv[2])
jax.config.update("jax_platforms", "cpu")
assert len(jax.devices()) >= n

sys.path.insert(0, ".")
from tidehunter_tpu.engine import Engine
from tidehunter_tpu.io.fastx import FastxRecord
from tidehunter_tpu.params import Params
from tidehunter_tpu.parallel.mesh import make_mesh
from tidehunter_tpu.tools.synth import synth_read

rng = np.random.default_rng(23)
reads = [
    FastxRecord(
        name=f"m{i}", comment="",
        seq=synth_read(rng, unit_len=55, copies=4, err=0.06, flank=25),
    )
    for i in range(reads_per_dev * n)
]
mtp = Params()
mesh = make_mesh(n)
engine = Engine(mtp, platform="gpu", mesh=mesh, interpret=True)
engine(reads, mtp)            # compile warmup
t0 = time.perf_counter()
res = engine(reads, mtp)
dt = time.perf_counter() - t0
ncons = sum(len(r.records) for r in res)
print(json.dumps({"n": n, "reads": len(reads), "wall_s": round(dt, 3),
                  "cons": ncons}))
""".replace("json.dumps", "__import__('json').dumps")


def main() -> int:
    env = dict(os.environ)
    flags = env.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        env["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    env["JAX_PLATFORMS"] = "cpu"
    rows = []
    for n in (1, 2, 4, 8):
        r = subprocess.run(
            [sys.executable, "-c", CHILD, str(n), "24"],
            capture_output=True, text=True, timeout=3000, env=env,
        )
        line = (r.stdout or "").strip().splitlines()
        if r.returncode != 0 or not line:
            print(f"# n={n} FAILED rc={r.returncode}: "
                  f"{(r.stderr or '')[-400:]}")
            return 1
        rows.append(json.loads(line[-1]))
        print(line[-1], flush=True)
    base = rows[0]["wall_s"] / rows[0]["reads"]
    print("# per-read wall (flat = batches shard, not duplicate; "
          "duplication would grow ~linearly with n):")
    for row in rows:
        pr = row["wall_s"] / row["reads"]
        print(f"#   n={row['n']}: {pr * 1e3:6.2f} ms/read "
              f"({pr / base:.2f}x of n=1)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
