#!/bin/bash
# Reduced-scale CPU insurance sweep: the full 15-config paper protocol
# through the host-oracle pipeline (production profile-POA, then the
# graph-POA oracle) at --reads N (default 120; the protocol scale is
# 1000 reads per config).
set -u
cd "$(dirname "$0")/.."
N=${1:-120}
python evals/accuracy.py \
  --reads "$N" --device off > evals/sweep_cpu_profile.log 2>&1
python evals/accuracy.py \
  --reads "$N" --device off --msa graph > evals/sweep_cpu_graph.log 2>&1
echo "sweep done $(date)" >> evals/sweep_cpu_profile.log
